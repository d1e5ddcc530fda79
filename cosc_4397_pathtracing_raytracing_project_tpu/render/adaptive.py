"""Variance-guided adaptive sampling over spatial pixel tiles.

Extension — the reference distributes samples strictly uniformly (one
sample per pixel per iteration, `pathtrace.cu:529-653`); there is no
adaptive machinery to port. Production renderers (Cycles, Arnold, PBRT's
StatsIntegrator) all ship one, and the mapping onto the fast pipeline is
direct:

- The fused SoA bounce body takes the pixels it traces as data
  (``ops.fast.trace_sample_fast(pixels=...)``), so "render only these K
  tiles" is gathering K tiles' pixel ids and tracing them as one flat
  batch — static shapes per K, no masking, no lanes spent on converged
  regions.
- Tile selection is carried as int32 *content* (tile ids + per-tile
  iteration bases, `render_tiles`), so refining a different tile set every
  round never recompiles.
- The noise oracle is the classic two-buffer estimate: samples alternate
  between accumulators A and B with equal counts; per-pixel squared
  half-buffer disagreement, box-reduced per tile, estimates each tile's
  remaining error. Everything stays on device; only the [T] error vector
  (a few hundred floats) crosses to the host when a caller asks for it.

Correctness notes:

- Every random draw is keyed by (seed, pixel, iteration, depth) — counter
  hashes and the per-pixel LD lattice — and each tile's iteration counter
  advances monotonically, so each pixel sees a deterministic,
  non-repeating sample stream whatever tile or device traces it; with
  ``sampler='sobol'`` a refined pixel consumes a contiguous prefix of its
  lattice.
- Per-pixel means accum/count are unbiased for any *fixed* allocation;
  data-driven allocation introduces the usual (negligible, universally
  accepted) stopping-time correlation — same trade every production
  adaptive sampler makes.
- Spatial tiles are bh×bw pixel blocks (default 32×64) rather than flat
  row bands: adaptivity needs squarish support. Partial edge blocks
  duplicate their last valid pixel into padding lanes and scatter those
  results into a trash slot.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fast
from ..scene.parser import load_scene_desc
from ..scene.structs import Scene, SceneDesc
from .engine import RenderConfig


def make_tile_layout(
    w: int, h: int, tile_shape: Tuple[int, int] = (32, 64)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Spatial block decomposition of a w×h frame into bh×bw tiles.

    Returns (px [T, bh·bw] i32, py [T, bh·bw] i32, idx [T, bh·bw] i32,
    valid [T] i32): per-tile pixel coordinates in row-major block order,
    the flat scatter index of each lane (== w·h for padding lanes — the
    caller's trash slot), and the count of valid lanes per tile."""
    bh, bw = (int(v) for v in tile_shape)
    if bh <= 0 or bw <= 0:
        raise ValueError(f"tile_shape {tile_shape} must be positive")
    ty = -(-h // bh)
    tx = -(-w // bw)
    t_ids = np.arange(ty * tx)
    by = (t_ids // tx) * bh  # block origin row
    bx = (t_ids % tx) * bw  # block origin col
    ly = np.arange(bh * bw) // bw  # lane offset within the block
    lx = np.arange(bh * bw) % bw
    yy = by[:, None] + ly[None, :]
    xx = bx[:, None] + lx[None, :]
    in_frame = (yy < h) & (xx < w)
    # padding lanes duplicate the clamped coordinate (a real pixel — its
    # radiance is valid, just redundant) and scatter to the trash slot
    yc = np.minimum(yy, h - 1)
    xc = np.minimum(xx, w - 1)
    idx = np.where(in_frame, yc * w + xc, w * h).astype(np.int32)
    return (
        xc.astype(np.int32),
        yc.astype(np.int32),
        idx,
        in_frame.sum(axis=1).astype(np.int32),
    )


def render_tiles(
    scene: Scene,
    config: RenderConfig,
    key: jnp.ndarray,
    pix: jnp.ndarray,  # [M, L] i32 global pixel id of every tile lane
    bases: jnp.ndarray,  # [M] i32 first iteration index of every tile
    num_samples: int,
    light_sampler=None,
) -> jnp.ndarray:
    """Radiance sums [M, L, 3] of `num_samples` samples per lane: tile m
    traces iterations bases[m] … bases[m] + num_samples − 1. Every draw is
    keyed by (pixel, iteration), so the result for a pixel does not depend
    on which tile row, batch or device traces it. Traced helper — callers
    jit."""
    m, lanes = pix.shape
    flat = pix.reshape(-1)
    it0 = jnp.repeat(bases, lanes)

    def one(acc, s):
        return acc + fast.trace_sample_fast(
            scene, config, key, it0 + s, light_sampler=light_sampler,
            pixels=flat,
        ), None

    rad, _ = jax.lax.scan(
        one,
        jnp.zeros((m * lanes, 3), jnp.float32),
        jnp.arange(num_samples, dtype=jnp.int32),
    )
    return rad.reshape(m, lanes, 3)


def _dispatch_ab(
    scene: Scene,
    acc_a: jnp.ndarray,  # [n+1, 3] — last row is the padding trash slot
    acc_b: jnp.ndarray,
    key: jnp.ndarray,
    tile_ids: jnp.ndarray,  # [K] i32 selected tiles
    base: jnp.ndarray,  # [K] i32 samples so far per tile (both buffers)
    pid_all: jnp.ndarray,  # [T, L] i32 layout tables
    idx_all: jnp.ndarray,  # [T, L] i32 scatter indices
    light_sampler,
    config: RenderConfig,
    k: int,  # samples per buffer
    mesh=None,
):
    """Render k samples into BOTH half-buffers for the selected tiles in a
    single batch: rows [0, K) advance buffer A's iteration window
    (base+1 … base+k), rows [K, 2K) buffer B's (base+k+1 … base+2k) —
    identical per-tile streams to two separate dispatches. K is static
    (tile_ids' shape); the selection is data. With a device `mesh`, the 2K
    rows shard over all devices (parallel.shard.render_tiles_sharded —
    no collective). Traced helper — callers jit."""
    ids2 = jnp.concatenate([tile_ids, tile_ids])
    bases2 = jnp.concatenate([base + 1, base + 1 + k])
    if mesh is None:
        rad = render_tiles(
            scene, config, key, pid_all[ids2], bases2, k, light_sampler
        )
    else:
        from ..parallel.shard import render_tiles_sharded

        rad = render_tiles_sharded(
            scene, config, key, pid_all[ids2], bases2, k, mesh,
            light_sampler=light_sampler,
        )
    rad = rad.reshape(2, -1, 3)
    flat_idx = idx_all[tile_ids].reshape(-1)
    acc_a = acc_a.at[flat_idx].add(rad[0])
    acc_b = acc_b.at[flat_idx].add(rad[1])
    return acc_a, acc_b


_warmup_step = partial(
    jax.jit,
    static_argnames=("config", "k", "mesh"),
    donate_argnums=(1, 2),
)(_dispatch_ab)


def _tile_errors(
    accum_a: jnp.ndarray,  # [n+1, 3]
    accum_b: jnp.ndarray,
    counts: jnp.ndarray,  # [T] i32 per-tile sample count PER BUFFER
    idx_all: jnp.ndarray,  # [T, L]
    valid: jnp.ndarray,  # [T]
) -> jnp.ndarray:
    """Two-buffer noise estimate per tile, in the metric that matters.

    Per pixel, E[(A/n − B/n)²] = 2σ²/n — twice the variance the combined
    2n-sample mean still carries — so the *squared* half-buffer difference
    is a direct estimate of each pixel's remaining MSE contribution
    (images are compared as clamped linear means, so the means are clamped
    to [0, 1] first: noise above the display range is invisible and must
    not attract samples). A relative metric (|A−B|/mean) loses to uniform
    sampling at equal budget — it pours samples into dark corners whose
    absolute error is already tiny."""
    n = accum_a.shape[0] - 1
    inv_c = (1.0 / jnp.maximum(counts.astype(jnp.float32), 1.0))[
        :, None, None
    ]
    da = jnp.clip(accum_a[idx_all] * inv_c, 0.0, 1.0)
    db = jnp.clip(accum_b[idx_all] * inv_c, 0.0, 1.0)
    e = jnp.mean((da - db) ** 2, axis=-1)  # [T, L]
    lane_ok = (idx_all < n).astype(jnp.float32)  # trash-slot gathers → 0
    return (e * lane_ok).sum(axis=1) / jnp.maximum(
        valid.astype(jnp.float32), 1.0
    )


@partial(
    jax.jit,
    static_argnames=("config", "k", "n_sel", "n_disp", "mesh"),
    donate_argnums=(1, 2, 3),
)
def _refine_round(
    scene: Scene,
    acc_a: jnp.ndarray,
    acc_b: jnp.ndarray,
    counts: jnp.ndarray,  # [T+1] i32 per-buffer tile counts (+ trash entry)
    key: jnp.ndarray,
    pid_all: jnp.ndarray,
    idx_all: jnp.ndarray,
    valid: jnp.ndarray,
    light_sampler,
    config: RenderConfig,
    k: int,
    n_sel: int,
    n_disp: int,
    mesh=None,
):
    """One fully device-resident refinement round: estimate per-tile noise,
    pick the `n_sel` tiles with the largest marginal MSE gain (lax.top_k),
    render `k` more samples into each half-buffer for them, bump their
    counts. `n_disp >= n_sel` pads the dispatch with the trash tile so the
    2·n_disp rows split evenly over a device mesh. No host transfer
    anywhere — rounds stream to the device and the Python loop never
    blocks."""
    err = _tile_errors(acc_a, acc_b, counts, idx_all, valid)
    # marginal gain of k more samples on tile t: err_t ≈ 2σ²/n_t, so
    # Δ(MSE) = σ²/(2n) − σ²/(2(n+k)) ∝ err·k/(n+k); k is shared → err/(n+k)
    gain = err / (counts.astype(jnp.float32) + jnp.float32(k))
    _, sel = jax.lax.top_k(gain[:-1], n_sel)  # real tiles only
    sel = sel.astype(jnp.int32)
    disp = sel
    if n_disp > n_sel:
        pad = jnp.full((n_disp - n_sel,), counts.shape[0] - 1, jnp.int32)
        disp = jnp.concatenate([sel, pad])
    acc_a, acc_b = _dispatch_ab(
        scene, acc_a, acc_b, key, disp, counts[disp] * 2,
        pid_all, idx_all, light_sampler, config, k, mesh,
    )
    counts = counts.at[sel].add(k)
    return acc_a, acc_b, counts, sel


class AdaptiveRenderer:
    """Host driver for adaptive rendering (the adaptive twin of
    engine.Renderer; analytic scenes, fast pipeline).

    Usage::

        r = AdaptiveRenderer("scenes/cornell.txt",
                             RenderConfig(sampler="sobol"))
        r.render(256)            # 256 average spp, adaptively placed
        img = r.linear_image()   # per-pixel mean (counts vary per tile)
        spp = r.spp_map()        # where the samples went

    Duck-compatible with render.denoise.denoise_image (scene, config,
    linear_image)."""

    def __init__(
        self,
        scene,
        config: Optional[RenderConfig] = None,
        seed: int = 0,
        tile_shape: Tuple[int, int] = (32, 64),
        mesh=None,
    ):
        if isinstance(scene, str):
            desc = load_scene_desc(scene)
            self.scene = Scene.from_desc(desc)
            if config is None:
                config = RenderConfig(trace_depth=desc.trace_depth)
            self.image_name = desc.image_name
        elif isinstance(scene, SceneDesc):
            self.scene = Scene.from_desc(scene)
            if config is None:
                config = RenderConfig(trace_depth=scene.trace_depth)
            self.image_name = scene.image_name
        else:
            self.scene = scene
            config = config or RenderConfig()
            self.image_name = "render"
        if not fast.supports(self.scene):
            raise ValueError(
                "adaptive sampling runs on the fast pipeline "
                "(analytic cube/sphere scenes)"
            )
        if config.dof is None:
            config = dataclasses.replace(
                config, dof=bool(float(self.scene.camera.aperture) > 0.0)
            )
        self.config = config

        w, h = self.scene.camera.resolution
        self._n = w * h
        px, py, idx, valid = make_tile_layout(w, h, tile_shape)
        self.num_tiles = px.shape[0]
        self._lanes = px.shape[1]
        # multi-device: every dispatch is a batch of 2·K tile rows split
        # evenly over the mesh (parallel.shard.render_tiles_sharded), so K
        # must be a multiple of the per-buffer quantum m (= n_dev for odd device
        # counts, n_dev/2 for even). Selections round UP into real tiles
        # first (padding slots do useful work when real tiles exist); any
        # remainder past num_tiles dispatches the trailing TRASH TILE — a
        # synthetic layout row whose lanes render tile 0's pixels but
        # scatter into the accumulators' trash slot, so any frame/mesh
        # combination is valid (no divisibility constraint on the layout).
        self._mesh = mesh
        self._n_dev = 1 if mesh is None else int(mesh.devices.size)
        self._quantum = (
            1 if self._n_dev == 1
            else (self._n_dev if self._n_dev % 2 else self._n_dev // 2)
        )
        self._pad_tile = self.num_tiles  # index of the trash-tile row
        px = np.concatenate([px, px[:1]])
        py = np.concatenate([py, py[:1]])
        idx = np.concatenate(
            [idx, np.full((1, idx.shape[1]), self._n, np.int32)]
        )
        valid = np.concatenate([valid, np.zeros(1, np.int32)])
        self._pid_all = jnp.asarray(py * w + px)
        self._idx_all = jnp.asarray(idx)
        self._valid = jnp.asarray(valid)

        # two half-buffer accumulators, each with a trailing trash slot
        self._acc_a = jnp.zeros((self._n + 1, 3), jnp.float32)
        self._acc_b = jnp.zeros((self._n + 1, 3), jnp.float32)
        # per-tile sample count PER BUFFER (total per pixel = 2×) — device-
        # resident so refinement rounds never touch the host; the trailing
        # entry absorbs the trash tile's bookkeeping
        self._counts = jnp.zeros(self.num_tiles + 1, jnp.int32)
        self._key = jax.random.PRNGKey(seed)
        self._lane_budget_spent = 0  # lanes × samples dispatched

        self._light_sampler = None
        if config.nee:
            from ..ops.lights import make_light_sampler

            self._light_sampler = make_light_sampler(self.scene)
            if self._light_sampler is None and self.scene.envmap is None:
                raise ValueError(
                    "nee: scene has no analytic (cube/sphere) emissive "
                    "lights and no ENVIRONMENT map to sample"
                )
        self._wall = 0.0

    # ── core dispatch ──

    def warmup(self, spp: int = 16) -> None:
        """Uniform bootstrap: spp total samples (spp//2 per buffer) on every
        tile — the two-buffer oracle needs a baseline everywhere."""
        k = max(1, spp // 2)
        # pad the all-tiles dispatch up to the mesh quantum with trash tiles
        kd = -(-self.num_tiles // self._quantum) * self._quantum
        ids = jnp.minimum(
            jnp.arange(kd, dtype=jnp.int32), jnp.int32(self._pad_tile)
        )
        t0 = time.perf_counter()
        self._acc_a, self._acc_b = _warmup_step(
            self.scene, self._acc_a, self._acc_b, self._key, ids,
            (self._counts * 2)[ids], self._pid_all, self._idx_all,
            self._light_sampler, self.config, k, self._mesh,
        )
        self._counts = self._counts.at[: self.num_tiles].add(k)
        self._lane_budget_spent += 2 * k * kd * self._lanes
        self._wall += time.perf_counter() - t0

    def tile_errors(self) -> np.ndarray:
        """[T] two-buffer noise estimate per tile (host copy; the render
        loop itself never fetches this — selection runs on device)."""
        return np.asarray(
            _tile_errors(
                self._acc_a, self._acc_b, self._counts,
                self._idx_all, self._valid,
            )
        )[: self.num_tiles]

    def refine(self, spp: int = 16, frac: float = 0.25) -> np.ndarray:
        """One adaptive round: give `spp` more samples each to the `frac`
        of tiles with the largest *marginal* MSE gain (see _refine_round —
        selection, render, and count bookkeeping all stay on device).
        Returns the selected tile ids (a device fetch; only callers who
        inspect it pay for the sync)."""
        k = max(1, spp // 2)
        n_sel = max(1, int(round(self.num_tiles * frac)))
        # sharded: the 2·n_disp-step dispatch must split evenly over the
        # mesh, so round the selection up to a multiple of the quantum —
        # into real tiles while any remain (the extra slots do useful
        # work), then trash-tile padding for the remainder.
        m = self._quantum
        n_sel = min(-(-n_sel // m) * m, self.num_tiles)
        n_disp = -(-n_sel // m) * m
        t0 = time.perf_counter()
        self._acc_a, self._acc_b, self._counts, sel = _refine_round(
            self.scene, self._acc_a, self._acc_b, self._counts, self._key,
            self._pid_all, self._idx_all, self._valid, self._light_sampler,
            self.config, k, n_sel, n_disp, self._mesh,
        )
        self._lane_budget_spent += 2 * k * n_disp * self._lanes
        self._wall += time.perf_counter() - t0
        return sel

    def render(
        self,
        avg_spp: int,
        warmup_spp: Optional[int] = None,
        round_spp: int = 32,
        frac: float = 0.25,
        progress: bool = False,
    ) -> "AdaptiveRenderer":
        """Adaptively spend an `avg_spp`-per-pixel sample budget: uniform
        warmup (default a quarter of the budget, ≥16), then top-`frac`
        refinement rounds of `round_spp` until the budget is consumed.
        The budget counts dispatched lanes (padding included), so the
        total device work matches a uniform `avg_spp` render."""
        budget = avg_spp * self._n
        if warmup_spp is None:
            warmup_spp = min(max(16, avg_spp // 4), avg_spp)
        # keep per-dispatch sample counts even (A/B split)
        q = 2
        warmup_spp = max(q, (warmup_spp // q) * q)
        round_spp = max(q, (round_spp // q) * q)
        if self._lane_budget_spent == 0:  # fresh start (not a resume)
            self.warmup(warmup_spp)
            if progress:
                print(f"warmup {warmup_spp} spp on {self.num_tiles} tiles")
        while self._lane_budget_spent < budget:
            sel = self.refine(round_spp, frac)
            if progress:
                e = self.tile_errors()
                print(
                    f"refine {len(sel)} tiles +{round_spp} spp  "
                    f"avg {self.avg_spp:.1f} spp  max_err {e.max():.4f}"
                )
        return self

    # ── outputs ──

    @property
    def avg_spp(self) -> float:
        """Average samples per pixel actually accumulated (valid lanes)."""
        c = np.asarray(self._counts, np.float64)
        v = np.asarray(self._valid, np.float64)
        return float((c * 2 * v).sum() / self._n)

    @property
    def iteration(self) -> int:
        """Average spp rounded down — the Renderer-compatible counter."""
        return int(self.avg_spp)

    def spp_map(self, per_buffer: bool = False) -> np.ndarray:
        """[H, W] int32 per-pixel sample count (the allocation picture)."""
        w, h = self.scene.camera.resolution
        scale = 1 if per_buffer else 2
        counts = np.zeros(self._n + 1, np.int64)
        idx = np.asarray(self._idx_all)
        tile_counts = np.asarray(self._counts, np.int64)
        for t in range(self.num_tiles):
            counts[idx[t]] = tile_counts[t] * scale
        return counts[: self._n].reshape(h, w).astype(np.int32)

    def linear_image(self) -> np.ndarray:
        """[H, W, 3] float32 per-pixel mean radiance (count-aware)."""
        w, h = self.scene.camera.resolution
        counts = self.spp_map().reshape(-1, 1).astype(np.float32)
        total = np.asarray(self._acc_a[: self._n] + self._acc_b[: self._n])
        return (total / np.maximum(counts, 1.0)).reshape(h, w, 3)

    def denoised_image(self, **kw) -> np.ndarray:
        from .denoise import denoise_image

        return denoise_image(self, **kw)

    def save_png(
        self, path: Optional[str] = None, denoise: bool = False
    ) -> str:
        """Write the PNG with the reference's save transform (linear clamp,
        no gamma, horizontal mirror, `main.cpp:86-107`) — same contract as
        Renderer.save_png, with the count-aware mean underneath."""
        from ..io.png import write_png
        from ..utils.timing import current_time_string

        lin = self.denoised_image() if denoise else self.linear_image()
        img = (np.clip(lin, 0.0, 1.0) * 255.0)[:, ::-1, :].astype(np.uint8)
        if path is None:
            path = (
                f"{self.image_name}.{current_time_string()}"
                f".{self.iteration}samp.png"
            )
        write_png(path, img)
        return path

    # ── checkpoint / resume (same contract as Renderer: per-tile iteration
    # counters key every stream, so resume is bit-identical) ──

    def save_checkpoint(self, path: str) -> str:
        from .checkpoint import save_adaptive_checkpoint

        meta = {
            "image_name": self.image_name,
            "resolution": list(map(int, self.scene.camera.resolution)),
            "num_tiles": int(self.num_tiles),
        }
        return save_adaptive_checkpoint(path, self, meta)

    def load_checkpoint(self, path: str) -> "AdaptiveRenderer":
        from .checkpoint import load_adaptive_checkpoint

        state, meta = load_adaptive_checkpoint(path)
        if state["counts"].shape[0] == self.num_tiles:
            # pre-padding checkpoint format: counts lacked the trash entry
            state["counts"] = jnp.concatenate(
                [state["counts"], jnp.zeros(1, jnp.int32)]
            )
        if state["acc_a"].shape != self._acc_a.shape or (
            state["counts"].shape[0] != self.num_tiles + 1
        ):
            raise ValueError(
                f"checkpoint layout ({state['acc_a'].shape[0] - 1} pixels, "
                f"{state['counts'].shape[0]} tiles) does not match renderer "
                f"({self._n} pixels, {self.num_tiles} tiles)"
            )
        self._acc_a = state["acc_a"]
        self._acc_b = state["acc_b"]
        self._counts = state["counts"]
        self._key = state["key"]
        self._lane_budget_spent = state["budget_spent"]
        return self

    def sync(self) -> None:
        self._acc_b.block_until_ready()

    @property
    def samples_per_second(self) -> float:
        """Dispatched primary samples per wall second (lane count /
        wall — comparable to the dense pipelines' rays/s when the frame
        divides evenly into blocks)."""
        return self._lane_budget_spent / max(self._wall, 1e-9)
