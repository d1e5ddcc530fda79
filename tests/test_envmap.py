"""Environment-map lighting (IBL extension) tests.

The reference's only environment is the hard-coded gradient sky
(`src/pathtrace.cu:358-362`); ops/envmap.py generalizes it to an arbitrary
equirect HDR with luminance-proportional importance sampling + MIS. Pins:
(a) the Radiance HDR codec round-trip incl. RLE scanlines, (b) the
direction↔uv mapping, (c) the sampler's exactness (its luminance estimator
has zero variance by construction, so E[L/pdf] must equal the texel Riemann
sum to float precision), (d) estimator physics end-to-end: a furnace test
(constant env → radiance = albedo × env on a convex body) and the
unbiasedness of env NEE+MIS against plain BRDF sampling under a hard
small-sun map."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cosc_4397_pathtracing_raytracing_project_tpu import Renderer, RenderConfig
from cosc_4397_pathtracing_raytracing_project_tpu.io.png import (
    read_hdr,
    write_hdr,
)
from cosc_4397_pathtracing_raytracing_project_tpu.ops import envmap as em
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu.scene.parser import (
    SceneParseError,
    load_scene_desc,
)
from cosc_4397_pathtracing_raytracing_project_tpu.scene.structs import Scene

HERE = os.path.dirname(__file__)
SCENES = os.path.join(HERE, "..", "scenes")


# ───────────────────────────── HDR codec ─────────────────────────────


def test_hdr_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = (rng.random((17, 33, 3)) * 100.0 + 0.01).astype(np.float32)
    img[3, 5] = [4000.0, 0.5, 1e-4]  # high dynamic range in one texel
    path = write_hdr(str(tmp_path / "rt.hdr"), img)
    back = read_hdr(path)
    assert back.shape == img.shape
    # shared-exponent quantization: 8-bit mantissa of the max channel
    rel = np.abs(back - img) / np.maximum(img.max(axis=2, keepdims=True), 1e-9)
    assert rel.max() < 1.0 / 128.0


def _rle_encode_channel(vals: np.ndarray) -> bytes:
    """Minimal Radiance RLE encoder (runs ≥ 4, literals ≤ 128) for the
    reader test."""
    out = bytearray()
    i, n = 0, len(vals)
    while i < n:
        run = 1
        while i + run < n and vals[i + run] == vals[i] and run < 127:
            run += 1
        if run >= 4:
            out += bytes([128 + run, int(vals[i])])
            i += run
        else:
            j = i + 1
            while (
                j < n
                and j - i < 128
                and not (
                    j + 3 < n
                    and vals[j] == vals[j + 1] == vals[j + 2] == vals[j + 3]
                )
            ):
                j += 1
            out += bytes([j - i]) + vals[i:j].tobytes()
            i = j
    return bytes(out)


def test_hdr_rle_decode(tmp_path):
    """The reader must handle adaptive-RLE scanlines (what stb/Radiance
    tools write); our writer emits flat, so encode by hand."""
    rng = np.random.default_rng(1)
    img = (rng.random((6, 32, 3)) * 8.0 + 0.125).astype(np.float32)
    img[:, 10:20] = 2.0  # runs for the RLE to compress
    flat_path = write_hdr(str(tmp_path / "flat.hdr"), img)
    with open(flat_path, "rb") as f:
        data = f.read()
    head_end = data.index(b"+X 32\n") + len(b"+X 32\n")
    rgbe = np.frombuffer(data[head_end:], np.uint8).reshape(6, 32, 4)
    body = bytearray()
    for y in range(6):
        body += bytes([2, 2, 0, 32])
        for c in range(4):
            body += _rle_encode_channel(rgbe[y, :, c])
    rle_path = tmp_path / "rle.hdr"
    rle_path.write_bytes(data[:head_end] + bytes(body))
    np.testing.assert_array_equal(read_hdr(str(rle_path)), read_hdr(flat_path))


# ─────────────────────────── mapping + sampler ───────────────────────────


def test_uv_dir_roundtrip():
    rng = np.random.default_rng(2)
    d = rng.normal(size=(500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u, v = em.dir_to_uv(jnp.asarray(d, jnp.float32))
    back = np.asarray(em.uv_to_dir(u, v))
    np.testing.assert_allclose(back, d, atol=2e-5)


def _random_env(h=16, w=32, seed=3, strength=1.0):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) ** 3 * 10.0).astype(np.float32)
    img[:4, :7] = 0.0  # a zero region (pdf floor must keep it sampleable)
    img[9, 20] = [900.0, 50.0, 10.0]  # one hard bright texel
    return em.build_envmap(img, strength), img


def test_pdf_integrates_to_one():
    env, img = _random_env()
    h, w = img.shape[:2]
    edges = np.linspace(0.0, np.pi, h + 1)
    omega = (np.cos(edges[:-1]) - np.cos(edges[1:]))[:, None] * (
        2 * np.pi / w
    )
    total = float((np.asarray(env.pdf) * omega).sum())
    assert abs(total - 1.0) < 1e-4


def test_sample_env_constant_map_zero_variance():
    """On a blur-invariant (constant) map, L/pdf equals the map integral
    for EVERY sample — pins the within-texel solid-angle-uniform sampling
    and the table normalization exactly."""
    img = np.full((12, 24, 3), 2.0, np.float32)
    env = em.build_envmap(img)
    u1, u2 = jax.random.uniform(jax.random.PRNGKey(8), (2, 5000))
    _, rad, pdf = em.sample_env(env, u1, u2)
    lum = np.asarray(rad) @ np.array([0.2126, 0.7152, 0.0722])
    np.testing.assert_allclose(
        lum / np.asarray(pdf), 2.0 * 4 * np.pi, rtol=3e-4
    )


def test_sample_env_unbiased_and_concentrated():
    """E[L/pdf] equals the map integral (pdf is a 3×3-blurred, floored
    luminance — positive wherever bilinear radiance is, see build_envmap),
    the returned pdf matches env_pdf() lookups, and the sample mass on the
    hard bright texel matches its table probability."""
    env, img = _random_env()
    h, w = img.shape[:2]
    key = jax.random.PRNGKey(4)
    u1, u2 = jax.random.uniform(key, (2, 200000))
    d, rad, pdf = em.sample_env(env, u1, u2)
    rad, pdf = np.asarray(rad), np.asarray(pdf)
    lum = rad @ np.array([0.2126, 0.7152, 0.0722])

    edges = np.linspace(0.0, np.pi, h + 1)
    omega = (np.cos(edges[:-1]) - np.cos(edges[1:]))[:, None] * (2 * np.pi / w)
    true_integral = float(
        (
            (
                0.2126 * img[..., 0]
                + 0.7152 * img[..., 1]
                + 0.0722 * img[..., 2]
            )
            * omega
        ).sum()
    )
    est = lum / pdf
    assert abs(est.mean() - true_integral) / true_integral < 0.01

    # pdf returned by the sampler == pdf looked up for the same direction
    # (an O(1e-5) fraction of samples sit exactly on a texel boundary and
    # may round into the neighbor after the float dir→uv roundtrip)
    pdf_back = np.asarray(em.env_pdf(env, d))
    mismatch = np.abs(pdf_back - pdf) > 1e-5 * np.abs(pdf)
    assert mismatch.mean() < 1e-4

    # the sampled directions must concentrate on the bright texel exactly
    # per its table probability mass
    uu, vv = em.dir_to_uv(d)
    x = np.clip((np.asarray(uu) * w).astype(int), 0, w - 1)
    y = np.clip((np.asarray(vv) * h).astype(int), 0, h - 1)
    frac_bright = float(np.mean((y == 9) & (x == 20)))
    expect = float(np.asarray(env.pdf)[9, 20] * omega[9, 0])
    assert abs(frac_bright - expect) < 0.01 * max(expect, 0.05) + 0.005


def test_radiance_lookup_matches_texels():
    """At texel centers the bilinear lookup returns the texel exactly;
    strength multiplies through. (Smooth map: dir→uv roundtrip float error
    bleeds a ~1e-5 fraction of the 4-texel neighborhood through the
    bilinear filter, so a spiked map would need a looser tolerance.)"""
    rng = np.random.default_rng(5)
    img = (rng.random((16, 32, 3)) * 4.0 + 0.2).astype(np.float32)
    env = em.build_envmap(img, 2.5)
    h, w = img.shape[:2]
    ys, xs = np.mgrid[2 : h - 2, 0:w]  # stay off the pole clamp rows
    u = (xs.ravel() + 0.5) / w
    v = (ys.ravel() + 0.5) / h
    d = em.uv_to_dir(jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32))
    got = np.asarray(em.env_radiance(env, d))
    np.testing.assert_allclose(
        got, img[ys.ravel(), xs.ravel()] * 2.5, rtol=1e-4, atol=1e-5
    )


# ─────────────────────────── scene + parser ───────────────────────────


def test_parser_environment_block():
    desc = load_scene_desc(os.path.join(SCENES, "env_spheres.txt"))
    assert desc.env_image is not None and desc.env_image.shape == (128, 256, 3)
    assert desc.env_strength == 1.0
    scene = Scene.from_desc(desc)
    assert scene.envmap is not None
    # envmap scenes resolve to the XLA fast pipeline, with or without NEE,
    # whatever the map's size
    assert RenderConfig().resolve_pipeline(scene) == "fast"
    assert RenderConfig(nee=True).resolve_pipeline(scene) == "fast"
    big = scene.envmap.replace(img=jnp.zeros((512, 1024, 3), jnp.float32))
    assert RenderConfig().resolve_pipeline(scene.replace(envmap=big)) == "fast"


def test_parser_environment_requires_file():
    text = "ENVIRONMENT\nSTRENGTH 2\n\nCAMERA\nRES 8 8\nFOVY 45\n" \
           "ITERATIONS 1\nDEPTH 2\nFILE x\nEYE 0 0 5\nLOOKAT 0 0 0\nUP 0 1 0\n"
    with pytest.raises(SceneParseError, match="FILE"):
        parse_scene(text)


def _furnace_scene(tmp_path, albedo=0.6, env_val=0.7, res=32):
    img = np.full((8, 16, 3), env_val, np.float32)
    write_hdr(str(tmp_path / "const.hdr"), img)
    text = f"""MATERIAL 0
RGB         {albedo} {albedo} {albedo}
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

ENVIRONMENT
FILE const.hdr
STRENGTH 1

CAMERA
RES         {res} {res}
FOVY        30
ITERATIONS  64
DEPTH       8
FILE        furnace
EYE         0 0 6
LOOKAT      0 0 0
UP          0 1 0

OBJECT 0
sphere
material 0
TRANS       0 0 0
ROTAT       0 0 0
SCALE       3 3 3
"""
    return parse_scene(text, base_dir=str(tmp_path))


@pytest.mark.parametrize("nee", [False, True])
def test_furnace(tmp_path, nee):
    """Constant environment c over a convex diffuse body with albedo a:
    every surface ray escapes after one bounce, so the body renders a·c and
    the background c — for BOTH estimators (BRDF-only and env NEE+MIS)."""
    desc = _furnace_scene(tmp_path)
    c = float(desc.env_image[0, 0, 0])  # 0.7 after RGBE quantization
    r = Renderer(desc, RenderConfig(samples_per_launch=16, nee=nee), seed=1)
    r.render(64)
    imgv = np.asarray(r.linear_image())
    h = imgv.shape[0]
    # center pixels hit the sphere; corners miss
    center = imgv[h // 2 - 2 : h // 2 + 2, h // 2 - 2 : h // 2 + 2]
    corner = imgv[:3, :3]
    np.testing.assert_allclose(corner, c, rtol=1e-5)
    np.testing.assert_allclose(center.mean(), 0.6 * c, rtol=0.02)


def _sun_scene(tmp_path, res=40):
    """Dim sky + one hard bright texel: the env-NEE stress case."""
    img = np.full((16, 32, 3), 0.05, np.float32)
    img[4, 7] = [120.0, 100.0, 80.0]
    write_hdr(str(tmp_path / "sun.hdr"), img)
    text = f"""MATERIAL 0
RGB         .7 .7 .7
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

ENVIRONMENT
FILE sun.hdr
STRENGTH 1

CAMERA
RES         {res} {res}
FOVY        35
ITERATIONS  64
DEPTH       4
FILE        sun
EYE         0 1.5 7
LOOKAT      0 0.5 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       0 -0.5 0
ROTAT       0 0 0
SCALE       20 1 20

OBJECT 1
sphere
material 0
TRANS       0 1 0
ROTAT       0 0 0
SCALE       2 2 2
"""
    return parse_scene(text, base_dir=str(tmp_path))


def test_fast_pipeline_pins_wavefront_env(tmp_path):
    """The SoA fast pipeline's env branches are estimator-identical to the
    wavefront's (different RNG stream layouts → statistical, not bitwise,
    agreement)."""
    desc = _sun_scene(tmp_path, res=32)
    means = {}
    for pipe in ("fast", "reference"):
        r = Renderer(
            desc,
            RenderConfig(
                nee=True, samples_per_launch=32, trace_depth=4, pipeline=pipe
            ),
            seed=3,
        )
        r.render(128)
        means[pipe] = float(np.asarray(r.linear_image()).mean())
    assert abs(means["fast"] - means["reference"]) / means["reference"] < 0.02


@pytest.mark.slow
def test_env_nee_unbiased_and_lower_variance(tmp_path):
    """env NEE+MIS has the same mean as plain BRDF sampling (unbiasedness)
    and far lower error at equal spp under a small hard sun."""
    desc = _sun_scene(tmp_path)
    cfg = dict(samples_per_launch=32, trace_depth=4)

    r_ref = Renderer(desc, RenderConfig(nee=False, **cfg), seed=7)
    r_ref.render(1536)  # heavy BRDF-only run = the mean ground truth
    ref = np.asarray(r_ref.linear_image())

    r_nee = Renderer(desc, RenderConfig(nee=True, **cfg), seed=11)
    r_nee.render(96)
    got = np.asarray(r_nee.linear_image())

    # unbiased: the two means agree (both are noisy; compare frame means)
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.04

    # variance: at EQUAL 96 spp, env NEE must beat BRDF-only by a wide
    # margin against the converged reference
    r_plain = Renderer(desc, RenderConfig(nee=False, **cfg), seed=11)
    r_plain.render(96)
    plain = np.asarray(r_plain.linear_image())
    err_nee = float(np.mean((got - ref) ** 2))
    err_plain = float(np.mean((plain - ref) ** 2))
    assert err_nee < 0.25 * err_plain
