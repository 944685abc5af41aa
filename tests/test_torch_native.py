"""The port's host block codecs (``comfyui_gguf_tpu_torch/native/``, its own
C++ library) against the numpy codecs: the port's (``codecs.ENCODERS`` /
``DECODERS`` / ``components_*``, ``planar.nib4_plane`` / ``int8_plane``)
and the reference's, with the reference's own C++ path switched off.

Every output must be byte-equal: encode on f32 inputs and on f16- and
bf16-rounded ones (with blocks built on Q4_0's near-ties, where a fused
multiply-add moves codes), edge blocks, decode and extraction of encoded
and of perturbed payloads, the planar re-tilings at widths that are not
multiples of 8 or 128, ``planarize`` / ``planarize_shards`` and a loaded
GGUF against the reference's, at 1 and 4 threads. A compiler that is
missing or fails raises: nothing falls back to numpy. Inputs are made
from a seed with numpy.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import native as jnative
from comfyui_gguf_tpu import pipeline as jpipeline
from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.quant import codecs as jcodecs
from comfyui_gguf_tpu.quant import planar as jplanar
from comfyui_gguf_tpu_torch import _build, native
from comfyui_gguf_tpu_torch.gguf.constants import (GGML_QUANT_SIZES,
                                                   GGMLQuantizationType as Q)
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.pipeline import load_diffusion_model
from comfyui_gguf_tpu_torch.quant import codecs, planar
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant

torch.set_num_threads(2)

ENCODE = [Q.Q4_0, Q.Q8_0, Q.Q4_K, Q.Q5_K, Q.Q6_K]
DECODE = [Q.Q4_0, Q.Q8_0, Q.Q4_K, Q.Q6_K]
# qtype -> (the library's extractor, the port's numpy one, the reference's)
EXTRACT = {
    Q.Q4_K: (native.extract_q4k, codecs.components_Q4_K,
             jcodecs.components_Q4_K),
    Q.Q5_K: (native.extract_q5k, codecs.components_Q5_K,
             jcodecs.components_Q5_K),
    Q.Q6_K: (native.extract_q6k, codecs.components_Q6_K,
             jcodecs.components_Q6_K),
    Q.Q3_K: (native.extract_q3k, codecs.components_Q3_K,
             jcodecs.components_Q3_K),
    Q.Q2_K: (native.extract_q2k, codecs.components_Q2_K,
             jcodecs.components_Q2_K),
}
INPUTS = ("f32", "f16", "bf16", "q4_0_ties_f16", "q4_0_ties_bf16", "edges")


@pytest.fixture(autouse=True)
def _reference_numpy_codecs(monkeypatch):
    """The reference's numpy codecs: its C++ path off (its Q4_0 encoder
    rounds some near-ties of f16/bf16-rounded blocks differently, ROADMAP
    queue 3)."""
    monkeypatch.setattr(jnative, "available",
                        lambda qtype, decode=False: False)
    for sym in ("extract_q4k", "extract_q5k", "extract_q6k", "extract_q3k",
                "extract_q2k", "pack_nib4_planar", "transpose_i8"):
        monkeypatch.setattr(jnative, sym, lambda *a, **k: None)


def _round(x, kind):
    if kind == "f16":
        return x.astype(np.float16).astype(np.float32)
    if kind == "bf16":
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _q4_0_ties(rng, n_blocks, kind):
    """Blocks whose codes sit on Q4_0's ties: element 0 is the signed
    absmax m, the others (k - 8.5) * d for d = f16(m / -8), each rounded
    to ``kind``; x * (1/d) + 8.5 then lands on or beside an integer."""
    m = rng.choice([-1.0, 1.0], n_blocks) * rng.uniform(0.05, 20, n_blocks)
    m = _round(m.astype(np.float32), kind)
    d = (m / np.float32(-8.0)).astype(np.float16).astype(np.float32)
    k = rng.integers(1, 16, (n_blocks, 32)).astype(np.float32)
    x = (k - np.float32(8.5)) * d[:, None]
    x[:, 0] = m
    return _round(x.astype(np.float32), kind).reshape(-1)


def _edges():
    """Edge blocks of 256: all zero, signed zeros each way, one large
    value among tiny ones, an absmax tied between +a and -a, values under
    half f16's least subnormal, one near f16's top and a constant."""
    z = np.zeros(256, np.float32)
    negz = np.full(256, -0.0, np.float32)
    first_negz = z.copy()
    first_negz[0] = -0.0
    mixed = np.where(np.arange(256) % 3 == 0, -0.0, 0.0).astype(np.float32)
    big = np.full(256, 1e-3, np.float32)
    big[77] = 6.0e4
    tie = np.linspace(-1, 1, 256).astype(np.float32)
    tie[5], tie[9] = -3.0, 3.0
    tiny = np.full(256, 1e-9, np.float32)
    tiny[::2] = -2e-9
    top = np.full(256, 5.0e5, np.float32)
    top[1::2] = -5.0e5
    const = np.full(256, 7.25, np.float32)
    return np.concatenate([z, negz, first_negz, mixed, big, tie, tiny, top,
                           const])


def _x(kind, seed, n_blocks=96):
    rng = np.random.default_rng(seed)
    if kind == "edges":
        return _edges()
    if kind.startswith("q4_0_ties"):
        return _q4_0_ties(rng, n_blocks * 8, kind.rsplit("_", 1)[1])
    x = rng.standard_normal(n_blocks * 256) * rng.uniform(0.01, 10)
    x[rng.integers(0, x.size, 8)] *= 50  # a few outliers
    return _round(x.astype(np.float32), kind)


def _numpy_encode(x, qtype):
    return codecs.ENCODERS[qtype](x).reshape(-1, GGML_QUANT_SIZES[qtype][1])


def _perturb(blocks, seed):
    """Encoded blocks with a quarter of their bytes flipped: bit patterns
    the encoders never write (NaN and subnormal f16 scales among them)."""
    rng = np.random.default_rng(seed)
    flat = np.ascontiguousarray(blocks).reshape(-1).copy()
    idx = rng.integers(0, flat.size, flat.size // 4)
    flat[idx] ^= rng.integers(1, 256, idx.size).astype(np.uint8)
    return flat.reshape(blocks.shape)


def _same_floats(a, b):
    """Equal bytes, where a NaN may differ from another NaN in its payload
    only (numpy's own f16 -> f32 conversion may quiet it)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a.view(np.uint32)[~nan],
                                  b.view(np.uint32)[~nan])


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("qtype", ENCODE, ids=lambda q: q.name)
def test_encode_is_byte_equal_to_the_numpy_codecs(qtype, kind):
    x = _x(kind, int(qtype))
    got = native.quantize(x, qtype)
    np.testing.assert_array_equal(got, _numpy_encode(x, qtype))
    np.testing.assert_array_equal(
        got, jcodecs.quantize(x, JQ(int(qtype)), use_native=False))
    np.testing.assert_array_equal(codecs.quantize(x, qtype), got)


@pytest.mark.parametrize("perturbed", [False, True],
                         ids=["encoded", "perturbed"])
@pytest.mark.parametrize("qtype", DECODE, ids=lambda q: q.name)
def test_decode_is_byte_equal_to_the_numpy_codecs(qtype, perturbed):
    x = _x("bf16", int(qtype) + 100, n_blocks=32)
    blocks = _numpy_encode(x, qtype)
    if perturbed:
        blocks = _perturb(blocks, int(qtype))
    got = native.dequantize(blocks, qtype, x.size)
    _same_floats(got, codecs.DECODERS[qtype](blocks).reshape(-1))
    _same_floats(got, jcodecs.dequantize(blocks, JQ(int(qtype)), (x.size,),
                                         use_native=False))
    _same_floats(codecs.dequantize(blocks, qtype, (8, x.size // 8)),
                 got.reshape(8, -1))


@pytest.mark.parametrize("perturbed", [False, True],
                         ids=["encoded", "perturbed"])
@pytest.mark.parametrize("qtype", list(EXTRACT), ids=lambda q: q.name)
def test_extract_is_byte_equal_to_the_numpy_extractors(qtype, perturbed):
    lib, port_numpy, ref_numpy = EXTRACT[qtype]
    blocks = _numpy_encode(_x("f16", int(qtype) + 7, n_blocks=48), qtype)
    if perturbed:
        blocks = _perturb(blocks, int(qtype) + 1)
    got = lib(blocks)
    for want in (port_numpy(blocks), ref_numpy(blocks),
                 codecs.COMPONENT_EXTRACTORS[qtype](blocks)):
        assert got[0].dtype == want.q.dtype
        np.testing.assert_array_equal(got[0], want.q)
        _same_floats(got[1], want.scales)
        if want.offsets is None:
            assert len(got) == 2
        else:
            _same_floats(got[2], want.offsets)


# (R, K): rows and half-rows that are not multiples of 8 or of 128
PLANES = [(1, 2), (7, 18), (9, 64), (130, 1024), (301, 162), (64, 512)]


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("R,K", PLANES)
def test_planar_retilings_equal_numpy(R, K, threads, torch_threads):
    torch_threads(threads)
    rng = np.random.default_rng(R * 1000 + K)
    rp = planar.padded_out_dim(R)
    nib = rng.integers(0, 16, (R, K)).astype(np.uint8)
    got = native.pack_nib4_planar(nib, rp)
    assert got.shape == (K // 2, rp) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, planar.nib4_plane(nib, rp))
    i8 = rng.integers(-128, 128, (R, K)).astype(np.int8)
    got = native.transpose_i8(i8, R + 3)
    np.testing.assert_array_equal(got, planar.int8_plane(i8, R + 3))


def test_the_retilings_refuse_what_numpy_would_not_pack():
    with pytest.raises(ValueError):
        native.pack_nib4_planar(np.zeros((4, 6), np.uint8), 3)
    with pytest.raises(ValueError):
        native.pack_nib4_planar(np.zeros((4, 7), np.uint8), 8)
    with pytest.raises(ValueError):
        native.dequantize(np.zeros((2, 144), np.uint8), Q.Q4_K, 3 * 256)
    with pytest.raises(ValueError):
        native.quantize(np.zeros(256, np.float32), Q.Q4_1)


def _planar_fields(p):
    return [np.asarray(p.qs), np.asarray(jnp.asarray(p.scales, jnp.float32)),
            None if p.offsets is None
            else np.asarray(jnp.asarray(p.offsets, jnp.float32))]


def _same_planar(got: PlanarQuant, want):
    assert (got.layout, got.group_size, got.zero_point, got.shape) == (
        want.layout, want.group_size, want.zero_point, tuple(want.shape))
    g = [got.qs.numpy(), got.scales.float().numpy(),
         None if got.offsets is None else got.offsets.float().numpy()]
    for a, b in zip(g, _planar_fields(want)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


PLANAR_QTYPES = [Q.Q4_0, Q.Q8_0, Q.Q2_K, Q.Q3_K, Q.Q4_K, Q.Q5_K, Q.Q6_K]


@pytest.mark.parametrize("qtype", PLANAR_QTYPES, ids=lambda q: q.name)
def test_planarize_equals_the_reference(qtype):
    R, K = 200, 768
    x = _x("bf16", int(qtype) + 3, n_blocks=R * K // 256).reshape(R, K)
    blocks = codecs.quantize(x, qtype)
    _same_planar(planar.planarize(blocks, qtype, (R, K)),
                 jplanar.planarize(blocks, JQ(int(qtype)), (R, K)))


@pytest.mark.parametrize("axis", ["r", "k"])
@pytest.mark.parametrize("qtype", [Q.Q4_K, Q.Q5_K, Q.Q6_K],
                         ids=lambda q: q.name)
def test_planarize_shards_equal_the_reference(qtype, axis):
    R, K = 256, 1024
    x = _x("f32", int(qtype) + 5, n_blocks=R * K // 256).reshape(R, K)
    blocks = codecs.quantize(x, qtype)
    got = planar.planarize_shards(blocks, qtype, (R, K), 2, axis=axis)
    want = jplanar.planarize_shards(blocks, JQ(int(qtype)), (R, K), 2,
                                    axis=axis)
    assert got.qs.shape[0] == 2
    _same_planar(got, want)


def _recipe(key, v):
    """A Q4_K_M-like mix over a flux file: Q5_K fused qkv, Q6_K second MLP
    linears, Q8_0 modulation, Q4_0 the single blocks' first linear, Q4_K
    the rest; float where K is not whole blocks."""
    if v.ndim != 2 or v.shape[1] % 256:
        return None
    if "qkv" in key:
        return Q.Q5_K
    if "mlp.2" in key:
        return Q.Q6_K
    if ".lin." in key:
        return Q.Q8_0
    if "linear1" in key:
        return Q.Q4_0
    return Q.Q4_K


def test_a_loaded_gguf_equals_the_reference(tmp_path):
    dims = testing.TinyFluxDims(hidden=512, heads=4, ctx=256, vec=256,
                                in_ch=16, depth_double=1, depth_single=1,
                                axes_dim=(16, 56, 56))
    sd = testing.flux_state_dict(dims, seed=11)
    path = str(tmp_path / "flux-mixed.gguf")
    testing.write_flux_gguf(sd, path, _recipe)
    model = load_diffusion_model(path, "cpu")
    jmodel = jpipeline.load_diffusion_model(path, prefer_pallas=False)
    assert set(model.params) == set(jmodel.params)
    kinds = set()
    for k, leaf in model.params.items():
        if isinstance(leaf, PlanarQuant):
            kinds.add(leaf.qtype)
            _same_planar(leaf, jmodel.params[k])
        else:
            np.testing.assert_array_equal(
                leaf.float().numpy(),
                np.asarray(jnp.asarray(jmodel.params[k], jnp.float32)), k)
    assert kinds == {int(q) for q in (Q.Q4_0, Q.Q8_0, Q.Q4_K, Q.Q5_K,
                                      Q.Q6_K)}


def _ops():
    """Each operation at a size that 4 threads split unevenly (past the
    library's least work a thread)."""
    x = _x("bf16", 3, n_blocks=517)
    b4 = _numpy_encode(x, Q.Q4_K)
    b6 = _numpy_encode(x, Q.Q6_K)
    rng = np.random.default_rng(9)
    nib = rng.integers(0, 16, (133, 4230)).astype(np.uint8)
    i8 = rng.integers(-128, 128, (133, 4230)).astype(np.int8)
    return {
        "encode_q4_0": (lambda: native.quantize(x, Q.Q4_0),
                        lambda: _numpy_encode(x, Q.Q4_0)),
        "encode_q5_k": (lambda: native.quantize(x, Q.Q5_K),
                        lambda: _numpy_encode(x, Q.Q5_K)),
        "decode_q4_k": (lambda: native.dequantize(b4, Q.Q4_K, x.size),
                        lambda: codecs.DECODERS[Q.Q4_K](b4).reshape(-1)),
        "extract_q6k": (lambda: native.extract_q6k(b6)[0],
                        lambda: codecs.components_Q6_K(b6).q),
        "pack_nib4": (lambda: native.pack_nib4_planar(nib, 256),
                      lambda: planar.nib4_plane(nib, 256)),
        "transpose_i8": (lambda: native.transpose_i8(i8, 256),
                         lambda: planar.int8_plane(i8, 256)),
    }


@pytest.fixture
def torch_threads():
    """Sets torch's thread count, which the library's calls take; restores
    it after the test."""
    before = torch.get_num_threads()
    yield torch.set_num_threads
    torch.set_num_threads(before)


@pytest.mark.parametrize("op", list(_ops()))
def test_one_and_four_threads_give_the_same_bytes(op, torch_threads):
    run, numpy_version = _ops()[op]
    torch_threads(1)
    one = run()
    torch_threads(4)
    np.testing.assert_array_equal(one, run())
    np.testing.assert_array_equal(one, numpy_version())


def test_the_covered_qtypes_run_on_the_library(monkeypatch):
    """codecs.quantize / dequantize / COMPONENT_EXTRACTORS and planarize
    call the library for what it covers and only for that."""
    calls = []
    real = native._call
    monkeypatch.setattr(native, "_call",
                        lambda name, *a: (calls.append(name), real(name, *a)))
    x = _x("f32", 1, n_blocks=4)
    for q in ENCODE:
        codecs.quantize(x, q)
    codecs.quantize(x, Q.Q4_1)
    assert calls == ["ggqt_quantize"] * len(ENCODE)
    calls.clear()
    for q in (*DECODE, Q.Q5_K, Q.Q4_1):
        codecs.dequantize(codecs.ENCODERS[q](x), q, x.shape)
    assert calls == ["ggqt_dequantize"] * len(DECODE)
    calls.clear()
    for q in EXTRACT:
        codecs.COMPONENT_EXTRACTORS[q](codecs.ENCODERS[q](x))
    assert calls == [f"ggqt_extract_{q.name[:2].lower()}k"
                     for q in EXTRACT]
    calls.clear()
    for q in (Q.Q4_K, Q.Q6_K):
        planar.planarize(codecs.ENCODERS[q](x), q, (4, 256))
    assert calls == ["ggqt_extract_q4k", "ggqt_pack_nib4_planar",
                     "ggqt_extract_q6k", "ggqt_transpose_i8"]


def _fake_compiler(path, compiles: bool):
    path.write_text("#!/bin/sh\n"
                    "if [ \"$1\" = --version ]; then echo fake-cxx 0.1; "
                    "exit 0; fi\n"
                    + ("exec c++ \"$@\"\n" if compiles else
                       "echo 'fake-cxx: no such target' >&2; exit 1\n"))
    path.chmod(0o755)
    return str(path)


@pytest.mark.parametrize("cxx", ["missing", "fails", "version_fails"])
def test_a_compiler_that_cannot_build_raises(monkeypatch, tmp_path, cxx):
    """No fallback: the codecs raise with the compiler's words and never
    return the numpy bytes instead."""
    exe = {"missing": str(tmp_path / "no-such-c++"),
           "fails": _fake_compiler(tmp_path / "cxx", compiles=False),
           "version_fails": "false"}[cxx]
    monkeypatch.setenv("CXX", exe)
    monkeypatch.setattr(_build, "_host_lib", None)
    x = _x("f32", 2, n_blocks=2)
    match = {"missing": "not found", "fails": "no such target",
             "version_fails": "--version failed"}[cxx]
    with pytest.raises(RuntimeError, match=match):
        codecs.quantize(x, Q.Q4_K)
    with pytest.raises(RuntimeError, match=match):
        planar.planarize(codecs.ENCODERS[Q.Q4_K](x), Q.Q4_K, (2, 256))
    assert _build._host_lib is None
    assert not [p for p in os.listdir(_build.BUILD_DIR)
                if p.startswith(f"host_tmp_{os.getpid()}_")]


def test_a_new_compiler_builds_a_library_of_its_own(monkeypatch, tmp_path):
    """The library's name follows the compiler, its flags and the source:
    another compiler builds beside the first, with the same bytes out."""
    first = _build.host_build()
    monkeypatch.setenv("CXX", _fake_compiler(tmp_path / "cxx", True))
    monkeypatch.setattr(_build, "_host_lib", None)
    try:
        second = _build.host_build()
        assert second != first and second.exists()
        assert _build.BUILD_REPORT["host"]["compiler"] == str(tmp_path /
                                                               "cxx")
        x = _x("bf16", 4, n_blocks=8)
        np.testing.assert_array_equal(native.quantize(x, Q.Q4_0),
                                      _numpy_encode(x, Q.Q4_0))
    finally:
        _build._host_lib = None
        if "second" in locals():
            second.unlink()
