"""Counter-based RNG for replayable, order-independent sampling.

The reference seeds a per-thread `thrust::default_random_engine` with an
avalanche hash of ``(iter, pixel, depth)`` (`src/pathtrace.cu:203-207`,
`src/intersections.h:12-20`). The equivalent here is JAX's counter-based
threefry: one base key per render, folded with the (iteration, depth)
coordinates, drawing a ``[N, lanes]`` block of uniforms per bounce. Every
kernel invocation is replayable from ``(seed, iter, depth)`` alone — same
property as the reference, without per-lane hash state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Uniform lanes drawn per path per bounce, by role. The reference draws up to
# five u01 samples per thread per bounce (`pathtrace.cu:368-436`): Russian
# roulette, branch selection, and 2-3 direction samples.
U_RR = 0  # Russian roulette keep/kill
U_BRANCH = 1  # specular-vs-diffuse branch
U_A = 2  # direction sample 1
U_B = 3  # direction sample 2
U_C = 4  # direction sample 3 (cone-perturb azimuth)
NUM_LANES = 5


def render_key(seed: int) -> jax.Array:
    return jax.random.PRNGKey(seed)


def bounce_key(base_key: jax.Array, iteration: jax.Array, depth) -> jax.Array:
    """Key for one (sample iteration, bounce depth) pair."""
    return jax.random.fold_in(jax.random.fold_in(base_key, iteration), depth)


def bounce_uniforms(base_key: jax.Array, iteration, depth, n: int) -> jax.Array:
    """``[n, NUM_LANES]`` float32 uniforms in [0, 1) for one bounce."""
    return jax.random.uniform(
        bounce_key(base_key, iteration, depth), (n, NUM_LANES), jnp.float32
    )


def _hash_seed(base_key: jax.Array, iteration, depth) -> jax.Array:
    """Scalar uint32 seed for one (render key, iteration, depth) triple.

    Injective (iteration, depth) -> counter for depth < 32, iteration < 2^27
    (a 5000-spp render uses < 2^13 iterations), pushed through the full
    murmur3 fmix32 finalizer (a bijection): no two (iteration, depth) pairs
    can share a seed, so the frame-wide duplicated-uniform-block collisions
    of the old single multiply-xor round cannot occur at all."""
    kd = jax.random.key_data(base_key).reshape(-1)[-1].astype(jnp.uint32)
    ctr = (jnp.asarray(iteration).astype(jnp.uint32) << jnp.uint32(5)) | (
        jnp.asarray(depth).astype(jnp.uint32) & jnp.uint32(31)
    )
    x = ctr ^ (kd * jnp.uint32(0x9E3779B9))
    x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x85EBCA6B)
    x = (x ^ (x >> jnp.uint32(13))) * jnp.uint32(0xC2B2AE35)
    return x ^ (x >> jnp.uint32(16))


def _hash_u01(seed: jax.Array, p: jax.Array, lane: int) -> jax.Array:
    """One pixel-keyed u01 lane: avalanche of ``p ^ (seed + lane·phi)``."""
    x = p ^ (seed + jnp.uint32(lane) * jnp.uint32(0x9E3779B9))
    x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> jnp.uint32(15))) * jnp.uint32(0x846CA68B)
    x = x ^ (x >> jnp.uint32(16))
    return (x >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0**-24)


def hash_bounce_uniforms(
    base_key: jax.Array, iteration, depth, pixel_ids: jax.Array
) -> jax.Array:
    """``[NUM_LANES, n]`` uniforms from a counter-hash keyed by PIXEL id.

    Drop-in replacement for ``bounce_uniforms`` on reordered wavefronts:
    u[l, i] is a pure function of (key, iteration, depth, pixel_ids[i], l),
    so a sorted wavefront draws exactly the pixel-keyed streams with **no
    gather** (threefry draws would need a [lanes, n] gather through the
    permutation). The hash is a murmur3-style avalanche; the reference's
    analog is its utilhash-seeded thrust engine
    (`src/pathtrace.cu:203-207`)."""
    seed = _hash_seed(base_key, iteration, depth)
    p = pixel_ids.astype(jnp.uint32)
    return jnp.stack([_hash_u01(seed, p, lane) for lane in range(NUM_LANES)])


def hash_nee_uniforms(
    base_key: jax.Array, iteration, depth, pixel_ids: jax.Array
) -> jax.Array:
    """``[n, 3]`` NEE uniforms from the counter-hash, keyed by PIXEL id —
    the reordered-wavefront twin of :func:`nee_uniforms` (the mesh pipeline
    resorts rays per bounce, so lane-indexed draws would violate the
    pixel-keyed-RNG invariant that makes sorting image-invariant). Uses
    hash lanes NUM_LANES..NUM_LANES+2, disjoint from the bounce draws."""
    seed = _hash_seed(base_key, iteration, depth)
    p = pixel_ids.astype(jnp.uint32)
    return jnp.stack(
        [_hash_u01(seed, p, lane) for lane in range(NUM_LANES, NUM_LANES + 3)],
        axis=-1,
    )


def _hash_lanes(base_key: jax.Array, iteration, depth, pixel_ids, lanes):
    """``[n, len(lanes)]`` counter-hash uniforms keyed by PIXEL id."""
    seed = _hash_seed(base_key, iteration, depth)
    p = pixel_ids.astype(jnp.uint32)
    return jnp.stack([_hash_u01(seed, p, lane) for lane in lanes], axis=-1)


def hash_env_uniforms(
    base_key: jax.Array, iteration, depth, pixel_ids: jax.Array
) -> jax.Array:
    """``[n, 2]`` environment-sampling uniforms keyed by PIXEL id — the
    pixel-keyed twin of :func:`env_uniforms` (hash lanes NUM_LANES+3 and
    NUM_LANES+4, disjoint from the bounce and NEE draws)."""
    return _hash_lanes(
        base_key, iteration, depth, pixel_ids, (NUM_LANES + 3, NUM_LANES + 4)
    )


def hash_camera_uniforms(
    base_key: jax.Array, iteration, pixel_ids: jax.Array
) -> jax.Array:
    """``[n, 4]`` camera uniforms keyed by PIXEL id: sub-pixel jitter
    (columns 0-1) and lens disk (columns 2-3) — the pixel-keyed twins of
    :func:`pixel_jitter` / :func:`lens_uniforms` (hash lanes
    NUM_LANES+5 … NUM_LANES+8 at depth 0)."""
    return _hash_lanes(
        base_key, iteration, 0, pixel_ids,
        tuple(range(NUM_LANES + 5, NUM_LANES + 9)),
    )


def nee_uniforms(base_key: jax.Array, iteration, depth, n: int) -> jax.Array:
    """``[n, 3]`` uniforms for direct light sampling (light pick + 2 surface
    coordinates; ops/lights.py). A separate fold tag keeps the existing
    bounce streams bit-identical whether or not NEE is enabled."""
    key = jax.random.fold_in(bounce_key(base_key, iteration, depth), 0x11EE)
    return jax.random.uniform(key, (n, 3), jnp.float32)


def env_uniforms(base_key: jax.Array, iteration, depth, n: int) -> jax.Array:
    """``[n, 2]`` uniforms for environment-map importance sampling
    (ops/envmap.py sample_env's alias-table draw: u1's integer part picks
    the cell, its fractional part decides stay-vs-alias and is re-used as
    the within-texel azimuth offset; u2 is the polar offset, uniform in
    solid angle within the texel's latitude band). A separate fold tag
    keeps every existing stream bit-identical whether or not the scene
    carries an ENVIRONMENT block."""
    key = jax.random.fold_in(bounce_key(base_key, iteration, depth), 0xE271)
    return jax.random.uniform(key, (n, 2), jnp.float32)


def pixel_jitter(base_key: jax.Array, iteration, n: int) -> jax.Array:
    """``[n, 2]`` sub-pixel jitter for antialiasing (extension: the reference
    generates rays through pixel corners with no jitter, `pathtrace.cu:278-282`)."""
    key = jax.random.fold_in(jax.random.fold_in(base_key, iteration), 0x7EA)
    return jax.random.uniform(key, (n, 2), jnp.float32)


# ── Low-discrepancy sampler (extension; RenderConfig.sampler='sobol') ──────
#
# Per-pixel OWEN-SCRAMBLED Sobol (0,2)-sequences for the estimator's most
# variance-critical dimensions (sub-pixel AA, lens disk, and the BSDF / NEE
# draws of the leading `ld_depths` bounces). The two Sobol components are
# pure bit functions of the sample index (hoisted per sample when the
# index is a scalar), and the per-pixel /
# per-dimension decorrelation is hash-based Owen scrambling (nested uniform
# scrambling via a Laine-Karras bit permutation — Burley, "Practical
# Hash-based Owen Scrambling", JCGT 2020): bit-reverse, a 4-round
# multiply-xor avalanche seeded by a per-(pixel, dimension-tag, seed) hash
# lattice, bit-reverse back. ~20 integer vector ops per draw, still cheaper
# than a full PRNG reseed+draw chain.
#
# Owen scrambling preserves each pair's elementary-interval stratification
# exactly (it is a nested scramble, so (0,2)-net structure survives), keeps
# every marginal uniform (estimator mean unchanged — only variance drops),
# decorrelates pixels (LD error turns into spatial noise, no structured
# aliasing), and — unlike the plain XOR digital shift this replaced —
# properly decorrelates dimension pairs that reuse the same (0,2)
# component: under an XOR shift two such draws have a CONSTANT XOR (their
# joint never fills the square, and the correlated error integrates
# coherently instead of averaging out — measured −4.9 dB at 1000 spp when
# padding a second bounce depth that way, 2026-08-19). Hash-based Owen
# padding is the standard construction for exactly this.
#
# The reference has no counterpart (its thrust engines are independent per
# (iter, pixel, depth), `src/pathtrace.cu:203-207`): this is the estimator
# extension that makes equal-spp renders converge faster, composing with NEE.

SOBOL_NBITS = 21  # supports 2^21 (~2M) sample indices before wrap

# Digital-shift dimension tags (each tag owns one per-pixel shift lattice).
LD_AA_X, LD_AA_Y = 0, 1
LD_LENS_U, LD_LENS_V = 2, 3
LD_BRANCH = 4
LD_BSDF_U, LD_BSDF_V = 5, 6
LD_PICK = 7
LD_NEE_U, LD_NEE_V = 8, 9
# Depths ≥ 1 reuse the same (0,2) pair under fresh shift lattices (padded
# Sobol, Kollig & Keller): 6 tags per extra depth, laid out after tag 9.
_LD_DEPTH_TAG_BASE = 10
_LD_DEPTH_STRIDE = 6


def ld_bounce_tags(depth: int) -> tuple:
    """(branch, bsdf_u, bsdf_v) shift-lattice tags for one bounce depth."""
    if depth == 0:
        return (LD_BRANCH, LD_BSDF_U, LD_BSDF_V)
    b = _LD_DEPTH_TAG_BASE + (depth - 1) * _LD_DEPTH_STRIDE
    return (b, b + 1, b + 2)


def ld_nee_tags(depth: int) -> tuple:
    """(pick, nee_u, nee_v) shift-lattice tags for one bounce depth."""
    if depth == 0:
        return (LD_PICK, LD_NEE_U, LD_NEE_V)
    b = _LD_DEPTH_TAG_BASE + (depth - 1) * _LD_DEPTH_STRIDE
    return (b + 3, b + 4, b + 5)


def _sobol_directions(nbits: int = SOBOL_NBITS) -> np.ndarray:
    """``[2, nbits]`` uint32 direction numbers for Sobol dims 1-2.

    Dim 0 is the van der Corput identity (v_k = 2^(31-k)); dim 1 follows the
    primitive polynomial x+1 (s=1): m_k = 2·m_{k-1} XOR m_{k-1}. Together
    they form the classic (0,2)-sequence in base 2 (t=0), verified by the
    elementary-interval tests in tests/test_render.py::TestSobol."""
    v0 = [np.uint32(1) << (31 - k) for k in range(nbits)]
    m = [1]
    for k in range(1, nbits):
        prev = m[k - 1]
        m.append((prev << 1) ^ prev)
    v1 = [np.uint32(m[k]) << (31 - k) for k in range(nbits)]
    return np.array([v0, v1], dtype=np.uint32)


_SOBOL_DIR = _sobol_directions()


def sobol_pair(index) -> tuple:
    """The (0,2)-sequence point for a scalar sample index, as two uint32.

    Pure bit math on the index (a scalar or an array of per-lane indices).
    Component 0 is the radical inverse (bit reversal); component 1 XORs direction
    numbers for set index bits. Bits ≥ SOBOL_NBITS are ignored (indices wrap
    past 2^21 — far beyond any configured sample count)."""
    n = jnp.asarray(index).astype(jnp.uint32)
    x0 = jnp.uint32(0)
    x1 = jnp.uint32(0)
    for k in range(SOBOL_NBITS):
        bit = (n >> jnp.uint32(k)) & jnp.uint32(1)
        # multiply-by-bit instead of a select
        x0 = x0 ^ (bit * jnp.uint32(_SOBOL_DIR[0, k]))
        x1 = x1 ^ (bit * jnp.uint32(_SOBOL_DIR[1, k]))
    return x0, x1


def ld_shift(base_key: jax.Array, pixel_ids: jax.Array, tag: int) -> jax.Array:
    """Per-(pixel, dimension-tag, seed) uint32 Owen-scramble seed lattice.

    Same murmur-style avalanche family as :func:`hash_bounce_uniforms`, on
    its own tag space (0x5D prefix) so LD seeds never collide with the
    bounce/NEE hash streams. (Named for the digital-shift lattice it grew
    from; the value now seeds :func:`ld_u01`'s Laine-Karras permutation.)"""
    kd = jax.random.key_data(base_key).reshape(-1)[-1].astype(jnp.uint32)
    seed = (jnp.uint32(0x5D000000) + jnp.uint32(tag)) ^ (
        kd * jnp.uint32(0x9E3779B9)
    )
    x = pixel_ids.astype(jnp.uint32) ^ seed
    x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> jnp.uint32(15))) * jnp.uint32(0x846CA68B)
    return x ^ (x >> jnp.uint32(16))


def bit_reverse32(x: jax.Array) -> jax.Array:
    """uint32 bit reversal (5 swap stages — pure vector shift/mask ops)."""
    x = jnp.asarray(x, jnp.uint32)
    x = ((x & jnp.uint32(0x55555555)) << jnp.uint32(1)) | (
        (x >> jnp.uint32(1)) & jnp.uint32(0x55555555)
    )
    x = ((x & jnp.uint32(0x33333333)) << jnp.uint32(2)) | (
        (x >> jnp.uint32(2)) & jnp.uint32(0x33333333)
    )
    x = ((x & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4)) | (
        (x >> jnp.uint32(4)) & jnp.uint32(0x0F0F0F0F)
    )
    x = ((x & jnp.uint32(0x00FF00FF)) << jnp.uint32(8)) | (
        (x >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF)
    )
    return (x << jnp.uint32(16)) | (x >> jnp.uint32(16))


def laine_karras(x: jax.Array, seed: jax.Array) -> jax.Array:
    """Laine-Karras hash permutation: a seeded avalanche whose bit i depends
    only on bits ≤ i (each round is x ^= x·even, which can only propagate
    information UPWARD), so conjugating it with bit reversal implements
    nested uniform (Owen) scrambling. Constants from Burley, JCGT 2020."""
    x = jnp.asarray(x, jnp.uint32) + jnp.asarray(seed, jnp.uint32)
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def ld_u01(sobol_bits, seed: jax.Array) -> jax.Array:
    """Owen-scrambled Sobol bits → float32 in [0, 1).

    Nested uniform scrambling (bit-reverse → Laine-Karras → bit-reverse):
    preserves elementary-interval stratification and decorrelates every
    (pixel, dimension-tag) stream. NB a value scramble alone cannot
    decorrelate two pads of the SAME component — both are permutations of
    one point set, so their joint lies on a function graph; cross-depth
    pads additionally shuffle the sample INDEX (:func:`ld_shuffled_index`),
    which is what makes their joints fill the square."""
    x = bit_reverse32(jnp.asarray(sobol_bits, jnp.uint32))
    x = bit_reverse32(laine_karras(x, seed))
    return (x >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0**-24)


# Shuffle-seed tag space for ld_shuffled_index: disjoint from the per-lane
# scramble tags (those stay < 256 for any practical ld_depths).
_LD_SHUFFLE_TAG_BASE = 256


def ld_shuffled_index(index, shuffle_seed: jax.Array) -> jax.Array:
    """Owen-shuffled sample index over the 2^SOBOL_NBITS index domain.

    Burley's shuffled-scrambled-Sobol construction (JCGT 2020): each pad
    (here: each bounce depth ≥ 1, per pixel) walks the SAME (0,2)-sequence
    in an independently Owen-permuted order. Nested-permutation closure
    means any power-of-2-aligned prefix of iterations still maps to an
    aligned block — and every aligned block of a (0,2)-sequence is itself
    a (0,m,2)-net — so per-depth stratification quality is fully
    preserved, while the JOINT of two depths' draws becomes a pseudo-random
    pairing of two stratified sets (Latin-hypercube-like) instead of the
    function graph a value scramble alone leaves.

    The permutation is LK conjugated with SOBOL_NBITS-bit reversal; the
    Laine-Karras nested property (output bit i depends on input bits ≤ i)
    makes masking its output to SOBOL_NBITS bits a bijection on the
    index domain."""
    nb = jnp.uint32(32 - SOBOL_NBITS)
    mask = jnp.uint32((1 << SOBOL_NBITS) - 1)
    j = bit_reverse32(jnp.asarray(index).astype(jnp.uint32)) >> nb
    jp = laine_karras(j, shuffle_seed) & mask
    return bit_reverse32(jp) >> nb


def ld_uniform_pair(
    base_key: jax.Array, iteration, pixel_ids: jax.Array, tag_u: int, tag_v: int
) -> tuple:
    """Convenience: the per-pixel shifted (0,2) pair for one dimension pair."""
    s0, s1 = sobol_pair(iteration)
    return (
        ld_u01(s0, ld_shift(base_key, pixel_ids, tag_u)),
        ld_u01(s1, ld_shift(base_key, pixel_ids, tag_v)),
    )


def ld_pixel_jitter(
    base_key: jax.Array, iteration, pixel_ids: jax.Array
) -> jax.Array:
    """``[n, 2]`` LD sub-pixel jitter — the ``sampler='sobol'`` twin of
    :func:`pixel_jitter`, keyed by PIXEL id (shard slices and block orders
    see the same jitter a full-frame render would)."""
    u, v = ld_uniform_pair(base_key, iteration, pixel_ids, LD_AA_X, LD_AA_Y)
    return jnp.stack([u, v], axis=1)


def ld_lens_uniforms(
    base_key: jax.Array, iteration, pixel_ids: jax.Array
) -> jax.Array:
    """``[n, 2]`` LD lens-disk uniforms — the ``sampler='sobol'`` twin of
    :func:`lens_uniforms` (pixel-keyed, own shift lattice)."""
    u, v = ld_uniform_pair(base_key, iteration, pixel_ids, LD_LENS_U, LD_LENS_V)
    return jnp.stack([u, v], axis=1)


def ld_bounce_uniforms(
    base_key: jax.Array, iteration, pixel_ids: jax.Array, depth: int = 0
) -> jax.Array:
    """``[NUM_LANES, n]`` LD bounce uniforms for ``sampler='sobol'``.

    The variance-critical lanes are LD: the specular/diffuse branch draw
    (shifted van der Corput) and the two hemisphere-direction draws (the
    shifted (0,2) pair — cosine directions stratify over the hemisphere,
    the classic largest single QMC win in a diffuse box). RR and the
    cone-azimuth lane stay on the counter-hash stream
    (:func:`hash_bounce_uniforms` lanes 0/4 at this depth): RR is closed
    before ``rr_start_depth`` anyway, and mixing hash lanes keeps the
    padded-sampler independence argument trivial.

    ``depth`` must be a static Python int: every depth owns its own
    scramble-seed lattices, and depths ≥ 1 additionally walk the sequence
    in a per-(pixel, depth) Owen-shuffled index order
    (:func:`ld_shuffled_index` — the padding construction that keeps
    cross-depth joints uniform), so early path vertices stay stratified
    even before RR decorrelates path lengths. ``RenderConfig.ld_depths``
    picks how deep the pipelines unroll this; deeper bounces fall back to
    :func:`hash_bounce_uniforms`. Depth 0 uses the raw index (scalar per
    iteration — bit-compatible with the original first-vertex sampler)."""
    seed = _hash_seed(base_key, iteration, depth)
    p = pixel_ids.astype(jnp.uint32)
    idx = _ld_depth_index(base_key, iteration, pixel_ids, depth)
    s0, s1 = sobol_pair(idx)
    t_branch, t_u, t_v = ld_bounce_tags(depth)
    return jnp.stack(
        [
            _hash_u01(seed, p, U_RR),
            ld_u01(s0, ld_shift(base_key, pixel_ids, t_branch)),
            ld_u01(s0, ld_shift(base_key, pixel_ids, t_u)),
            ld_u01(s1, ld_shift(base_key, pixel_ids, t_v)),
            _hash_u01(seed, p, U_C),
        ]
    )


def _ld_depth_index(
    base_key: jax.Array, iteration, pixel_ids: jax.Array, depth: int
):
    """Sample index for one bounce depth: the raw iteration at depth 0
    (scalar, bit-compatible with the first-vertex-only sampler), the
    per-(pixel, depth) Owen-shuffled index past it (cross-depth pad
    decorrelation — see :func:`ld_shuffled_index`)."""
    if depth == 0:
        return iteration
    return ld_shuffled_index(
        iteration, ld_shift(base_key, pixel_ids, _LD_SHUFFLE_TAG_BASE + depth)
    )


def ld_nee_bounce_uniforms(
    base_key: jax.Array, iteration, pixel_ids: jax.Array, depth: int = 0
) -> jax.Array:
    """``[n, 3]`` LD NEE uniforms for ``sampler='sobol'``: light pick
    (scrambled van der Corput) + the light-surface (0,2) pair, per-depth
    scramble lattices and (depth ≥ 1) the same shuffled index as
    :func:`ld_bounce_uniforms` at that depth. Layout matches
    :func:`nee_uniforms` / :func:`hash_nee_uniforms`."""
    idx = _ld_depth_index(base_key, iteration, pixel_ids, depth)
    s0, s1 = sobol_pair(idx)
    t_pick, t_u, t_v = ld_nee_tags(depth)
    return jnp.stack(
        [
            ld_u01(s0, ld_shift(base_key, pixel_ids, t_pick)),
            ld_u01(s0, ld_shift(base_key, pixel_ids, t_u)),
            ld_u01(s1, ld_shift(base_key, pixel_ids, t_v)),
        ],
        axis=-1,
    )


def ld_bounce0_uniforms(
    base_key: jax.Array, iteration, pixel_ids: jax.Array
) -> jax.Array:
    """Depth-0 :func:`ld_bounce_uniforms` (bit-identical historical alias)."""
    return ld_bounce_uniforms(base_key, iteration, pixel_ids, 0)


def ld_nee0_uniforms(
    base_key: jax.Array, iteration, pixel_ids: jax.Array
) -> jax.Array:
    """Depth-0 :func:`ld_nee_bounce_uniforms` (bit-identical alias)."""
    return ld_nee_bounce_uniforms(base_key, iteration, pixel_ids, 0)


def lens_uniforms(base_key: jax.Array, iteration, n: int) -> jax.Array:
    """``[n, 2]`` lens-disk uniforms for thin-lens depth of field (extension:
    the reference camera is strictly pinhole). Keyed like ``pixel_jitter``
    but on its own fold constant, so enabling DOF never perturbs the
    antialias or bounce streams."""
    key = jax.random.fold_in(jax.random.fold_in(base_key, iteration), 0xD0F)
    return jax.random.uniform(key, (n, 2), jnp.float32)
