"""Smoke test of the renderer on an NVIDIA GPU: the quickest proof that the
system starts and renders correctly on the card.

    python chip_smoke.py               # one GPU, every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded paths only

Phases, one line each (``[name] ok|FAIL (seconds) ...``):

  card      nvidia-smi name + power limit, JAX device kind
  cornell   Cornell 800×800, depth 8, sobol, through Renderer → 'fast':
            rays/s over 500 samples, compile seconds, peak device bytes
  golden    cornell_golden 800×800, antialias, light_only, sobol, 1000 spp:
            PSNR against tests/data/REFERENCE_cornell.5000samp.png ≥ 33 dB
  parity    'fast' against the readable 'reference' pipeline (run at
            HIGHEST matmul precision): fused intersector vs intersect_scene
            on 2^20 random rays, then 64-spp renders after 8×8 block means
  classes   one short render per scene class through Renderer 'auto', each
            within 5% of the reference pipeline's mean: glass, Cornell+NEE,
            env (exact, ± NEE), mesh1080p 1920×1080 4 spp (rays/s of
            'fast_mesh' and 'reference'), adaptive 32 spp, denoised image

With --four-cards only the multi-device paths run — make_sharded_step, the
sharded mesh step and the sharded adaptive renderer, each on a
make_mesh(4, sample_parallel=2) mesh against the same render on one card
(Cornell 800×800, 64 spp) — with 1-card and 4-card rays/s.

The last line is ``{"ok": true, "device": {...}}`` only when every phase
passed; otherwise the script exits 1 without it. It exits 1 before any
phase when JAX finds no GPU: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(REPO, "scenes")
GOLDEN_PNG = os.path.join(REPO, "tests", "data", "REFERENCE_cornell.5000samp.png")

GOLDEN_MIN_PSNR_DB = 33.0
PARITY_REL_MEAN = 0.02
PARITY_MIN_CORR = 0.98
CLASS_REL_MEAN = 0.05


class CheckFailed(AssertionError):
    """A smoke check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


# ── comparison helpers (plain NumPy; tested on the CPU) ──


def block_mean(img: np.ndarray, block: int = 8) -> np.ndarray:
    """[H, W, C] → [H//block, W//block, C] box means (edge rows/cols that
    do not fill a block are dropped)."""
    h, w = img.shape[0] // block * block, img.shape[1] // block * block
    x = np.asarray(img, np.float64)[:h, :w]
    return x.reshape(h // block, block, w // block, block, -1).mean(axis=(1, 3))


def agreement(a: np.ndarray, b: np.ndarray, block: int = 8):
    """(relative difference of the means, correlation of the block-mean
    luminance) between two [H, W, 3] mean-radiance images; b is the
    reference."""
    ba, bb = block_mean(a, block), block_mean(b, block)
    rel = abs(ba.mean() - bb.mean()) / max(abs(bb.mean()), 1e-12)
    corr = float(np.corrcoef(ba.mean(-1).ravel(), bb.mean(-1).ravel())[0, 1])
    return float(rel), corr


def check_agreement(name: str, a, b, rel_tol=PARITY_REL_MEAN,
                    min_corr=PARITY_MIN_CORR, block: int = 8) -> str:
    rel, corr = agreement(a, b, block)
    msg = f"{name}: mean rel diff {rel:.5f} (< {rel_tol}), corr {corr:.5f} (> {min_corr})"
    check(rel < rel_tol and corr > min_corr, msg)
    return msg


def mean_rel_diff(a, b) -> float:
    """Relative difference of the image means (b is the reference)."""
    return abs(float(np.mean(a)) - float(np.mean(b))) / max(abs(float(np.mean(b))), 1e-12)


def golden_psnr(linear: np.ndarray, ref_u8: np.ndarray) -> float:
    """PSNR (dB) of a linear render against the 8-bit golden PNG, with the
    reference's save transform (clamp, horizontal mirror)."""
    mine = np.clip(np.asarray(linear, np.float64), 0.0, 1.0)[:, ::-1, :]
    ref = np.asarray(ref_u8, np.float64) / 255.0
    mse = float(((mine - ref) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-30))


def rays_per_second(pixels: int, samples: int, seconds: float) -> float:
    """Primary samples per second (`pathtrace.cu:173`)."""
    return pixels * samples / seconds


# ── phases ──


class Smoke:
    def __init__(self):
        self.failed = []
        self.card = "card unknown"

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            msg, status = fn(), "ok"
        except Exception as e:  # reported, counted, and fails the run
            traceback.print_exc(file=sys.stderr)
            msg, status = f"{type(e).__name__}: {e}", "FAIL"
            self.failed.append(name)
        print(f"[{name}] {status} ({time.perf_counter() - t0:.1f} s) {msg}",
              flush=True)

    # (a)
    def phase_card(self):
        from cosc_4397_pathtracing_raytracing_project_tpu.utils import device

        lines = device.card_lines()
        rec = device.device_record()
        self.card = " | ".join(lines)
        return (f"nvidia-smi: {self.card}; jax: {rec['platform']} "
                f"{rec['kind']} x{rec['count']}")


def _renderer(scene, seed: int = 0, **cfg):
    from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Renderer

    return Renderer(scene, RenderConfig(**cfg), seed=seed)


def _timed_render(r, spp: int) -> float:
    """Wall seconds to render `spp` samples from a fresh accumulator, after
    one warm-up chunk (compiles every shape the timed loop uses)."""
    r.reset()
    r.step(min(r.config.samples_per_launch, spp))
    r.reset()
    t0 = time.perf_counter()
    r.render(spp)
    r.sync()
    return time.perf_counter() - t0


def phase_cornell(smoke: Smoke, spp: int = 500, chunk: int = 100):
    import jax

    r = _renderer(os.path.join(SCENES, "cornell.txt"), trace_depth=8,
                  sampler="sobol", samples_per_launch=chunk)
    pipeline = r.config.resolve_pipeline(r.scene)
    check(pipeline == "fast", f"Cornell resolved to {pipeline!r}, not 'fast'")
    t0 = time.perf_counter()
    r.step(chunk)  # compile + one chunk
    first = time.perf_counter() - t0
    r.reset()
    t0 = time.perf_counter()
    r.render(spp)
    r.sync()
    wall = time.perf_counter() - t0
    img = r.linear_image()
    check(np.isfinite(img).all() and img.max() > 0, "Cornell image not finite/positive")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "n/a")
    rate = rays_per_second(r.scene.camera.pixel_count, spp, wall)
    compile_s = max(first - wall * chunk / spp, 0.0)
    return (f"Cornell 800x800 depth 8 sobol, pipeline fast: {rate:.6e} rays/s "
            f"({spp} spp in {wall:.4f} s, chunk {chunk}); compile ~{compile_s:.2f} s "
            f"(first call {first:.2f} s); peak_bytes_in_use {peak}; card {smoke.card}")


def phase_golden(smoke: Smoke, spp: int = 1000):
    from cosc_4397_pathtracing_raytracing_project_tpu.io.png import read_png

    r = _renderer(os.path.join(SCENES, "cornell_golden.txt"), antialias=True,
                  gather_mode="light_only", sampler="sobol",
                  samples_per_launch=100)
    r.render(spp)
    db = golden_psnr(r.linear_image(), read_png(GOLDEN_PNG))
    msg = f"golden PSNR {db:.3f} dB at {spp} spp (>= {GOLDEN_MIN_PSNR_DB})"
    check(db >= GOLDEN_MIN_PSNR_DB, msg)
    return msg


def _reference_render(scene, spp: int, seed: int = 1, **cfg):
    """The readable reference pipeline at HIGHEST matmul precision."""
    import jax

    with jax.default_matmul_precision("highest"):
        r = _renderer(scene, seed=seed, pipeline="reference",
                      samples_per_launch=16, **cfg)
        r.render(spp)
        return r.linear_image()


def phase_parity(smoke: Smoke, n_rays: int = 1 << 20, spp: int = 64):
    import jax
    import jax.numpy as jnp

    from cosc_4397_pathtracing_raytracing_project_tpu import Scene
    from cosc_4397_pathtracing_raytracing_project_tpu.ops import fast, intersect
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc

    scene = Scene.from_desc(load_scene_desc(os.path.join(SCENES, "cornell.txt")))
    rng = np.random.default_rng(0)
    o = rng.uniform(-6, 11, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(intersect.intersect_scene)(scene, jnp.asarray(o), jnp.asarray(d))
    got = jax.jit(fast.intersect_unrolled)(
        scene, *(jnp.asarray(o[:, i]) for i in range(3)),
        *(jnp.asarray(d[:, i]) for i in range(3)),
    )
    miss_ref, miss_got = np.asarray(ref.miss), np.asarray(got.miss)
    miss_agree = float((miss_ref == miss_got).mean())
    both = ~miss_ref & ~miss_got
    t_ref, t_got = np.asarray(ref.t)[both], np.asarray(got.t)[both]
    t_ok = bool(np.allclose(t_got, t_ref, rtol=2e-3, atol=2e-3))
    isect_msg = (f"intersector on {n_rays} rays: miss agreement {miss_agree:.6f} "
                 f"(> 0.995), t within 2e-3: {t_ok}")
    check(miss_agree > 0.995 and t_ok, isect_msg)

    path = os.path.join(SCENES, "cornell.txt")
    r = _renderer(path, samples_per_launch=16)
    check(r.config.resolve_pipeline(r.scene) == "fast", "Cornell not on 'fast'")
    r.render(spp)
    fast_img = r.linear_image()
    ref_img = _reference_render(path, spp)
    smoke.cornell_reference = ref_img
    return isect_msg + "; " + check_agreement(f"{spp}-spp renders (8x8 blocks)",
                                              fast_img, ref_img)


def _mean_check(name, img, ref, pipeline) -> str:
    rel = mean_rel_diff(img, ref)
    check(np.isfinite(img).all(), f"{name}: non-finite pixels")
    msg = f"{name} [{pipeline}] mean rel diff {rel:.5f}"
    check(rel < CLASS_REL_MEAN, msg + f" (>= {CLASS_REL_MEAN})")
    return msg


def _progress(msg: str) -> None:
    print(f"  .. {msg}", file=sys.stderr, flush=True)


def phase_classes(smoke: Smoke, spp: int = 32):
    from cosc_4397_pathtracing_raytracing_project_tpu.render.adaptive import (
        AdaptiveRenderer,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig

    out = []
    cornell = os.path.join(SCENES, "cornell.txt")
    cases = [
        ("glass", os.path.join(SCENES, "cornell_glass.txt"),
         dict(enable_refraction=True)),
        ("cornell+nee", cornell, dict(nee=True)),
        ("env", os.path.join(SCENES, "env_spheres.txt"), dict()),
        ("env+nee", os.path.join(SCENES, "env_spheres.txt"), dict(nee=True)),
    ]
    for name, path, cfg in cases:
        r = _renderer(path, samples_per_launch=spp, **cfg)
        pipeline = r.config.resolve_pipeline(r.scene)
        r.render(spp)
        out.append(_mean_check(name, r.linear_image(),
                               _reference_render(path, spp, **cfg), pipeline))
        _progress(out[-1])

    # triangle mesh at full 1080p: the auto route ('reference') and
    # 'fast_mesh', timed, the latter checked against the former
    mesh = os.path.join(SCENES, "mesh1080p.txt")
    mesh_spp = 4
    rr = _renderer(mesh, samples_per_launch=mesh_spp)
    pipeline = rr.config.resolve_pipeline(rr.scene)
    wall_ref = _timed_render(rr, mesh_spp)
    _progress(f"mesh1080p {pipeline}: {mesh_spp} spp in {wall_ref:.3f} s")
    r = _renderer(mesh, pipeline="fast_mesh", samples_per_launch=mesh_spp)
    wall = _timed_render(r, mesh_spp)
    _progress(f"mesh1080p fast_mesh: {mesh_spp} spp in {wall:.3f} s")
    px = r.scene.camera.pixel_count
    out.append(_mean_check("mesh1080p", r.linear_image(), rr.linear_image(),
                           "fast_mesh")
               + f", auto → {pipeline} {rays_per_second(px, mesh_spp, wall_ref):.6e}"
               f" rays/s, fast_mesh {rays_per_second(px, mesh_spp, wall):.6e} rays/s")

    ref = getattr(smoke, "cornell_reference", None)
    if ref is None:
        ref = _reference_render(cornell, 64)
    a = AdaptiveRenderer(cornell, RenderConfig(sampler="sobol"))
    a.render(32)
    out.append(_mean_check("adaptive 32spp", a.linear_image(), ref, "adaptive"))

    r = _renderer(cornell, samples_per_launch=spp)
    r.render(4 * spp)
    out.append(_mean_check(f"denoised {4 * spp}spp", r.denoised_image(), ref,
                           "fast+denoise"))
    return "; ".join(out)


def _triangulated_cornell_desc():
    """Cornell with every non-emissive cube replaced by its 12 triangles (the
    light stays an analytic cube) — the mesh pipeline's Cornell."""
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc

    desc = load_scene_desc(os.path.join(SCENES, "cornell.txt"))
    corners = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                        for z in (-.5, .5)], np.float64)
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
             (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    keep, tris, tri_mat = [], [], []
    for i in range(desc.num_geoms):
        emissive = desc.emittance[desc.material_id[i]] > 0
        if desc.geom_type[i] != 0 or emissive:
            keep.append(i)
            continue
        world = (desc.transform[i][:3, :3] @ corners.T).T + desc.transform[i][:3, 3]
        for f in faces:
            tris.append(world[list(f)])
            tri_mat.append(desc.material_id[i])
    for field in ("geom_type", "material_id", "translation", "rotation", "scale",
                  "transform", "inv_transform", "inv_transpose"):
        setattr(desc, field, getattr(desc, field)[keep])
    desc.tri_vertices = np.asarray(tris, np.float32)
    desc.tri_material_id = np.asarray(tri_mat, np.int32)
    return desc


def phase_four_cards(smoke: Smoke, spp: int = 64):
    import jax

    from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Renderer, Scene
    from cosc_4397_pathtracing_raytracing_project_tpu.parallel import (
        make_mesh,
        make_sharded_mesh_step,
        make_sharded_step,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.render.adaptive import (
        AdaptiveRenderer,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.render.state import RenderState
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 GPUs, JAX has {len(jax.devices())}")
    mesh = make_mesh(4, sample_parallel=2)
    out = []

    def sharded_vs_single(name, desc, make_step, pipeline):
        scene = Scene.from_desc(desc)
        cfg = RenderConfig(trace_depth=desc.trace_depth)
        # one card runs the pipeline the sharded step runs
        one = Renderer(desc, dataclasses.replace(
            cfg, samples_per_launch=spp, pipeline=pipeline))
        t1 = _timed_render(one, spp)
        step = make_step(scene, cfg, spp, mesh)
        state = RenderState.create(scene.camera.pixel_count, seed=0)
        jax.block_until_ready(step(scene, state).accum)  # compile
        t0 = time.perf_counter()
        acc = step(scene, state).accum
        acc.block_until_ready()
        t4 = time.perf_counter() - t0
        w, h = scene.camera.resolution
        img4 = np.asarray(acc).reshape(h, w, 3) / spp
        px = scene.camera.pixel_count
        return check_agreement(f"{name} 4-card vs 1-card", img4, one.linear_image()) + (
            f", 1 card {rays_per_second(px, spp, t1):.6e} rays/s"
            f", 4 cards {rays_per_second(px, spp, t4):.6e} rays/s")

    cornell = load_scene_desc(os.path.join(SCENES, "cornell.txt"))
    out.append(sharded_vs_single("make_sharded_step", cornell, make_sharded_step,
                                 "fast"))
    out.append(sharded_vs_single("sharded mesh step", _triangulated_cornell_desc(),
                                 make_sharded_mesh_step, "fast_mesh"))

    def adaptive(m):
        def run():
            a = AdaptiveRenderer(os.path.join(SCENES, "cornell.txt"),
                                 RenderConfig(sampler="sobol"), mesh=m)
            t0 = time.perf_counter()
            a.render(spp)
            a.sync()
            return a, time.perf_counter() - t0

        run()  # compiles the warmup and refinement shapes
        a, wall = run()
        return a.linear_image(), a._lane_budget_spent / wall

    img1, rate1 = adaptive(None)
    img4, rate4 = adaptive(mesh)
    out.append(check_agreement("sharded adaptive 4-card vs 1-card", img4, img1)
               + f", 1 card {rate1:.6e} samples/s, 4 cards {rate4:.6e} samples/s")
    return "; ".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded paths against 1 card")
    args = ap.parse_args(argv)

    from cosc_4397_pathtracing_raytracing_project_tpu.utils import device
    from cosc_4397_pathtracing_raytracing_project_tpu.utils.cache import (
        enable_compile_cache,
    )

    try:
        device.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()

    smoke = Smoke()
    smoke.run("card", smoke.phase_card)
    if args.four_cards:
        smoke.run("four-cards", lambda: phase_four_cards(smoke))
    else:
        smoke.run("cornell", lambda: phase_cornell(smoke))
        smoke.run("golden", lambda: phase_golden(smoke))
        smoke.run("parity", lambda: phase_parity(smoke))
        smoke.run("classes", lambda: phase_classes(smoke))
    print(f"card: {smoke.card}")
    if smoke.failed:
        print(f"chip_smoke: FAILED phases: {', '.join(smoke.failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device.device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
