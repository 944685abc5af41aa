"""The port's GGUF loader against the reference package's.

Both packages load the same files — the golden all-formats GGUF and a small
flux GGUF written as tests/test_flux.py writes one — and must agree on keys,
shapes and qtypes (stage 1) and on every dense value and planar component
(stage 2), exactly.
"""

import os

import numpy as np
import pytest
import torch

from comfyui_gguf_tpu.loader import gguf_sd_loader as j_sd_loader
from comfyui_gguf_tpu.loader import to_jax_params
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.loader import gguf_sd_loader, to_torch_params
from comfyui_gguf_tpu_torch.models import testing
from comfyui_gguf_tpu_torch.quant.planar import PlanarQuant

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "codecs_v1.gguf")
DIMS = testing.TinyFluxDims(hidden=512, heads=4, depth_double=1,
                            depth_single=1, axes_dim=(16, 56, 56))


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32)


def _assert_same_trees(jparams, tparams):
    assert sorted(jparams) == sorted(tparams)
    for k, jv in jparams.items():
        tv = tparams[k]
        if hasattr(jv, "layout"):
            assert isinstance(tv, PlanarQuant), k
            assert (tv.layout, tv.group_size, tv.zero_point, tv.shape,
                    tv.qtype) == (jv.layout, jv.group_size, jv.zero_point,
                                  jv.shape, jv.qtype), k
            np.testing.assert_array_equal(tv.qs.numpy(), np.asarray(jv.qs))
            np.testing.assert_array_equal(tv.scales.numpy(),
                                          np.asarray(jv.scales))
            if jv.offsets is None:
                assert tv.offsets is None
            else:
                np.testing.assert_array_equal(tv.offsets.numpy(),
                                              np.asarray(jv.offsets))
        else:
            assert str(tv.dtype).split(".")[-1] == str(jv.dtype), k
            np.testing.assert_array_equal(tv.float().numpy(), _f32(jv))


def _stage1(path):
    j, jarch = j_sd_loader(path, return_arch=True)
    t, tarch = gguf_sd_loader(path, return_arch=True)
    assert jarch == tarch
    assert list(j) == list(t)
    for k in j:
        assert (j[k].shape, int(j[k].qtype)) == (t[k].shape, int(t[k].qtype))
        assert j[k].is_largest_weight == t[k].is_largest_weight
    return j, t


def test_golden_all_formats_load_identically():
    j, t = _stage1(GOLDEN)
    assert len(t) == 15
    _assert_same_trees(to_jax_params(j), to_torch_params(t, device="cpu"))


@pytest.fixture(scope="module")
def flux_gguf(tmp_path_factory):
    sd = testing.flux_state_dict(DIMS, seed=0)
    path = str(tmp_path_factory.mktemp("flux") / "tiny_q4k.gguf")
    testing.write_flux_gguf(
        sd, path, lambda k, v: testing.flux_block_qtype(k, v, Q.Q4_K))
    return path


def test_flux_gguf_loads_identically(flux_gguf):
    j, t = _stage1(flux_gguf)
    assert sum(v.is_quantized for v in t.values()) == 13
    _assert_same_trees(to_jax_params(j), to_torch_params(t, device="cpu"))


def test_entry_point_refuses_missing_card(flux_gguf):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_torch_params(gguf_sd_loader(flux_gguf))
