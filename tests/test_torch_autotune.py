"""The port's tile table and autotuner bookkeeping on the CPU: the keys,
the JSON round trip, the lookup ``qmm_cuda`` makes before its plan, the
legality filter, and the refusals (an illegal entry, a tuner without a
card). Timing candidates needs the card (tests/test_torch_cuda.py)."""

import os
import subprocess
import sys

import pytest
import torch

from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.models.testing import random_planar
from comfyui_gguf_tpu_torch.ops import autotune, qmatmul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _empty_table():
    qmatmul.SHAPE_TILES.clear()
    yield
    qmatmul.SHAPE_TILES.clear()


def _pq(qtype=Q.Q4_K, shape=(256, 1024)):
    gen = torch.Generator().manual_seed(0)
    return random_planar(qtype, shape, gen, device="cpu")


def test_shape_key_buckets_m():
    assert qmatmul.shape_key(4608, 3072, 3072, "nib4") == \
        qmatmul.shape_key(8192, 3072, 3072, "nib4")
    assert qmatmul.shape_key(4096, 3072, 3072, "nib4")[0] == 4096
    assert qmatmul.shape_key(512, 3072, 9216, "int8") == \
        (512, 3072, 9216, "int8")
    assert [qmatmul._m_bucket(m) for m in (0, 1, 2, 3, 129, 4608)] == \
        [1, 1, 2, 4, 256, 8192]


def test_save_load_roundtrip(tmp_path):
    key = qmatmul.shape_key(4608, 3072, 3072, "nib4")
    qmatmul.SHAPE_TILES[key] = (2, 1)
    qmatmul.SHAPE_TILES[qmatmul.shape_key(512, 3072, 9216, "int8")] = (1, 4)
    want = dict(qmatmul.SHAPE_TILES)
    f = str(tmp_path / "tiles.json")
    autotune.save(f)
    qmatmul.SHAPE_TILES.clear()
    assert autotune.load(f) == 2
    assert qmatmul.SHAPE_TILES == want


def test_shape_tiles_consulted():
    """The entry is used before the plan; without one the plan's pick is
    returned unchanged for every shape."""
    for m in (9, 128, 129, 512, 4096, 4608):
        for kp, r in ((3072, 3072), (3072, 9216), (15360, 3072),
                      (4096, 10240), (512, 320)):
            rp = -(-r // 128) * 128
            assert (qmatmul.wgmma_tiles(m, kp, r, rp, "nib4")
                    == qmatmul.wgmma_split_plan(m, kp, r))
    key = qmatmul.shape_key(4608, 3072, 3072, "nib4")
    plan = qmatmul.wgmma_split_plan(4608, 3072, 3072)
    tuned = (1, 2) if plan != (1, 2) else (2, 1)
    qmatmul.SHAPE_TILES[key] = tuned
    assert qmatmul.wgmma_tiles(4608, 3072, 3072, 3072, "nib4") == tuned
    assert qmatmul.wgmma_tiles(5000, 3072, 3072, 3072, "nib4") == tuned
    # another layout, R or bucket keeps the plan
    assert qmatmul.wgmma_tiles(4608, 3072, 3072, 3072, "int8") == plan
    assert qmatmul.wgmma_tiles(4096, 3072, 3072, 3072, "nib4") == \
        qmatmul.wgmma_split_plan(4096, 3072, 3072)


def test_illegal_table_entry_raises():
    # Kp = 512: 8 K steps, so a split of 8 (16 steps) cannot divide them
    qmatmul.SHAPE_TILES[qmatmul.shape_key(512, 512, 384, "nib4")] = (1, 8)
    with pytest.raises(ValueError, match="SHAPE_TILES"):
        qmatmul.wgmma_tiles(512, 512, 300, 384, "nib4")
    qmatmul.SHAPE_TILES[qmatmul.shape_key(512, 3072, 384, "nib4")] = (3, 1)
    with pytest.raises(ValueError, match="SHAPE_TILES"):
        qmatmul.wgmma_tiles(512, 3072, 300, 384, "nib4")


def test_load_checks_each_entry(tmp_path, monkeypatch):
    """A file's entries are outside input: a split the body cannot take or
    a malformed key raises at load and adds nothing; an unset variable or
    a cache not yet written loads nothing."""
    qmatmul.SHAPE_TILES[qmatmul.shape_key(4608, 3072, 3072, "nib4")] = (2, 1)
    want = dict(qmatmul.SHAPE_TILES)
    bad = tmp_path / "bad.json"
    for text, match in (
            ('{"[512, 3072, 9216, \\"int8\\"]": [2, 4], '
             '"[512, 512, 384, \\"nib4\\"]": [1, 8]}', "does not fit"),
            ('{"[512, 3072, 9216, \\"int8\\"]": [3, 1]}', "does not fit"),
            ('{"[512, 3072, \\"int8\\"]": [2, 4]}', "malformed"),
            ('{"[512, 3072, 9216, \\"q4\\"]": [2, 4]}', "malformed"),
            ('{"[512, 3072, 9216, \\"int8\\"]": [2]}', "malformed")):
        bad.write_text(text)
        with pytest.raises(ValueError, match=match):
            autotune.load(str(bad))
        assert qmatmul.SHAPE_TILES == want
    monkeypatch.delenv("GGUF_TPU_TILE_CACHE", raising=False)
    assert autotune.load_from_env() == 0
    monkeypatch.setenv("GGUF_TPU_TILE_CACHE", str(tmp_path / "none.json"))
    assert autotune.load_from_env() == 0
    monkeypatch.setenv("GGUF_TPU_TILE_CACHE", str(bad))
    with pytest.raises(ValueError, match="malformed"):
        autotune.load_from_env()
    assert qmatmul.SHAPE_TILES == want


def test_legal_filter():
    pq = _pq()  # Kp 1024: 16 K steps
    assert autotune._legal(pq, 64, (1, 1))
    assert autotune._legal(pq, 64, (1, 8))
    assert not autotune._legal(pq, 64, (2, 1))  # 256-token tile, 64 tokens
    assert autotune._legal(pq, 512, (2, 8))
    assert not autotune._legal(pq, 512, (1, 3))  # no instance
    assert not autotune._legal(pq, 4, (1, 1))  # the split-K body takes M=4
    small_k = _pq(shape=(256, 512))  # Kp 512: 8 K steps
    assert not autotune._legal(small_k, 512, (2, 8))
    assert set(autotune.CANDIDATES) == {(nt, s) for nt in (1, 2)
                                         for s in qmatmul.WGMMA_SPLITS}


def test_tuner_raises_without_a_card():
    """Timing CPU matmuls would tune nothing: every entry point that times
    raises, and the table stays empty."""
    pq = _pq()
    with pytest.raises(RuntimeError, match="card"):
        autotune._profile_ms(pq, 512)
    with pytest.raises(RuntimeError, match="card"):
        autotune.tune_shape(pq, 512)
    with pytest.raises(RuntimeError, match="card"):
        autotune.tune_for_params({"w": pq, "blocks": {"w": pq}}, 512)
    assert qmatmul.SHAPE_TILES == {}


def test_tune_for_params_walks_flat_and_stacked_trees(monkeypatch):
    """One tuning per distinct shape key, over flat leaves, depth-stacked
    leaves (block 0) and nested groups; the stub stands in for the timing,
    which needs the card."""
    gen = torch.Generator().manual_seed(1)
    flat = random_planar(Q.Q4_K, (256, 1024), gen, device="cpu")
    stacked = random_planar(Q.Q4_K, (256, 1024), gen, device="cpu", stack=3)
    other = random_planar(Q.Q5_K, (384, 1024), gen, device="cpu", stack=2)
    calls = []

    def fake_tune(pq, m, candidates, times=None):
        calls.append((pq.qs.shape, m))
        if times is not None:
            times[(1, 1)] = 1.0
        return (1, 1)

    monkeypatch.setattr(autotune, "tune_shape", fake_tune)
    times = {}
    got = autotune.tune_for_params(
        {"a": flat, "b": "dense", "g": {"s": stacked, "o": other}}, 4608,
        times=times)
    assert got == {qmatmul.shape_key(4608, 1024, 256, "nib4"): (1, 1),
                   qmatmul.shape_key(4608, 1024, 384, "int8"): (1, 1)}
    assert set(times) == set(got)
    assert calls == [((512, 256), 4608), ((1024, 384), 4608)]


def test_tile_cache_is_read_on_import(tmp_path):
    f = tmp_path / "tiles.json"
    f.write_text('{"[8192, 3072, 3072, \\"nib4\\"]": [2, 1]}')
    out = subprocess.run(
        [sys.executable, "-c",
         "from comfyui_gguf_tpu_torch.ops import autotune, qmatmul; "
         "print(qmatmul.SHAPE_TILES)"],
        env={**os.environ, "GGUF_TPU_TILE_CACHE": str(f),
             "PYTHONPATH": ROOT}, capture_output=True, text=True,
        check=True, timeout=120)
    assert out.stdout.strip() == "{(8192, 3072, 3072, 'nib4'): (2, 1)}"


def _load_with_cache(tmp_path, table_text):
    """Run load_diffusion_model on the CPU in a fresh process with
    GGUF_TPU_TILE_CACHE naming a file of ``table_text``; the table is
    printed before and after."""
    from comfyui_gguf_tpu_torch.models import testing

    dims = testing.TinyFluxDims(depth_double=1, depth_single=1)
    gguf = tmp_path / "flux.gguf"
    testing.write_flux_gguf(testing.flux_state_dict(dims), str(gguf),
                            lambda k, v: None)
    f = tmp_path / "tiles.json"
    f.write_text(table_text)
    code = ("from comfyui_gguf_tpu_torch.pipeline import "
            "load_diffusion_model; from comfyui_gguf_tpu_torch.ops import "
            "qmatmul; print(qmatmul.SHAPE_TILES); "
            f"load_diffusion_model({str(gguf)!r}, 'cpu'); "
            "print(qmatmul.SHAPE_TILES)")
    return subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "GGUF_TPU_TILE_CACHE": str(f),
             "PYTHONPATH": ROOT}, capture_output=True, text=True,
        timeout=120)


def test_load_diffusion_model_reads_the_tile_cache(tmp_path):
    """With GGUF_TPU_TILE_CACHE set, loading a model fills the table."""
    out = _load_with_cache(tmp_path,
                           '{"[512, 3072, 9216, \\"int8\\"]": [2, 4]}')
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == [
        "{}", "{(512, 3072, 9216, 'int8'): (2, 4)}"]


def test_load_diffusion_model_rejects_an_illegal_tile_cache(tmp_path):
    """An entry the wgmma body cannot take fails the model's load, not its
    first launch in a denoise."""
    out = _load_with_cache(tmp_path,
                           '{"[512, 3072, 9216, \\"int8\\"]": [2, 5]}')
    assert out.returncode != 0
    assert "ValueError" in out.stderr and "does not fit" in out.stderr
