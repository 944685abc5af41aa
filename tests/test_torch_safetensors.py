"""The port's own safetensors reader and writer against the ``safetensors``
package (present where these tests run; the port itself never imports it).

Files written by either side are read by the other and compared bit for
bit, for every dtype the reader takes (F32, F16, BF16, I8, I32, I64), a
0-d tensor and an empty one; ``load_state_dict`` widens bf16/f16 to f32 as
the reference's ``_load_safetensors_sd`` does.
"""

import numpy as np
import pytest
import safetensors.torch
import torch

from comfyui_gguf_tpu import pipeline as ref_pipeline
from comfyui_gguf_tpu_torch import _safetensors as st


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "a.f32": torch.randn((3, 5), generator=g),
        "b.f16": torch.randn((4, 2, 2), generator=g).to(torch.float16),
        "c.bf16": torch.randn((7,), generator=g).to(torch.bfloat16),
        "d.i8": torch.randint(-128, 128, (2, 9), generator=g,
                              dtype=torch.int8),
        "e.i32": torch.randint(-2**31, 2**31 - 1, (5,), generator=g,
                               dtype=torch.int32),
        "f.i64": torch.tensor([[2**40, -3]], dtype=torch.int64),
        "g.scalar": torch.tensor(4.0),
        "h.empty": torch.zeros((0, 3)),
    }


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def test_reader_takes_the_package_writer(tmp_path):
    path = str(tmp_path / "pkg.safetensors")
    want = _tensors()
    safetensors.torch.save_file(want, path, metadata={"format": "pt"})
    got = st.load_file(path)
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])


def test_package_reader_takes_the_writer(tmp_path):
    path = str(tmp_path / "own.safetensors")
    want = _tensors()
    st.save_file(want, path, metadata={"made_by": "test"})
    got = safetensors.torch.load_file(path)
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])
    own = st.load_file(path)
    for k in want:
        _same(own[k], want[k])


def test_state_dict_widens_like_the_reference(tmp_path):
    path = str(tmp_path / "sd.safetensors")
    st.save_file(_tensors(), path)
    got = st.load_state_dict(path)
    want = ref_pipeline._load_safetensors_sd(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["b.f16"].dtype == np.float32
    assert got["c.bf16"].dtype == np.float32


def test_writer_takes_numpy_and_reader_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "np.safetensors")
    st.save_file({"x": np.arange(6, dtype=np.float32).reshape(2, 3)}, path)
    np.testing.assert_array_equal(st.load_state_dict(path)["x"],
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    with pytest.raises(NotImplementedError):
        st.save_file({"x": torch.zeros(2, dtype=torch.float64)}, path)
    bad = str(tmp_path / "f64.safetensors")
    safetensors.torch.save_file({"x": torch.zeros(2, dtype=torch.float64)},
                                bad)
    with pytest.raises(NotImplementedError, match="F64"):
        st.load_file(bad)
    with pytest.raises(ValueError):
        trunc = tmp_path / "trunc.safetensors"
        trunc.write_bytes(open(path, "rb").read()[:-4])
        st.load_file(str(trunc))
