"""The port's shape specs (models/testing.py) against the reference's: the
validator's expected keys and shapes come from them, so both packages must
give the same {key: shape} for tiny and published dims."""

import dataclasses

import pytest

from comfyui_gguf_tpu.models import testing as jT
from comfyui_gguf_tpu_torch.models import testing as T


def _flat(spec):
    if isinstance(spec, dict):
        return {k: tuple(v) for k, v in spec.items()}
    nonblock, groups = spec
    out = {k: tuple(v) for k, v in nonblock.items()}
    for ok, (depth, suf) in groups.items():
        for i in range(depth):
            out.update({f"{ok}.{i}.{s}": tuple(sh) for s, sh in suf.items()})
    return out


def _ref_dims(cls_name, dims):
    """The reference's dims dataclass with the port's field values."""
    return getattr(jT, cls_name)(**dataclasses.asdict(dims))


CASES = [
    ("flux_shape_spec", "TinyFluxDims", T.TinyFluxDims(), {}),
    ("flux_shape_spec", "TinyFluxDims", T.FLUX_DEV_DIMS, {}),
    ("flux_shape_spec", "TinyFluxDims", T.FLUX_DEV_DIMS,
     {"guidance": False}),
    ("sd3_shape_spec", "TinySD3Dims", T.TinySD3Dims(), {}),
    ("sd3_shape_spec", "TinySD3Dims", T.TinySD3Dims(qk_norm=False), {}),
    ("sd3_shape_spec", "TinySD3Dims", T.SD35_LARGE_DIMS, {}),
    ("sd3_shape_spec", "TinySD3Dims", T.SD35_MEDIUM_DIMS, {}),
    ("qwen_image_shape_spec", "QwenImageDims", T.QWEN_IMAGE_20B_DIMS, {}),
    ("hidream_shape_spec", "TinyHiDreamDims", T.HIDREAM_I1_DIMS, {}),
    ("wan_shape_spec", "WanDims", T.WAN_14B_DIMS, {}),
    ("hyvid_shape_spec", "HyVidDims", T.HYVID_13B_DIMS, {}),
    ("ltxv_shape_spec", "LTXVDims", T.LTXV_2B_DIMS, {}),
    ("cosmos_shape_spec", "CosmosDims", T.COSMOS_7B_DIMS, {}),
    ("aura_shape_spec", "AuraDims", T.AURA_V03_DIMS, {}),
    ("lumina2_shape_spec", "Lumina2Dims", T.LUMINA2_DIMS, {}),
]


@pytest.mark.parametrize("fn,cls,dims,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_shape_spec_equals_reference(fn, cls, dims, kw):
    got = _flat(getattr(T, fn)(dims, **kw))
    want = _flat(getattr(jT, fn)(_ref_dims(cls, dims), **kw))
    assert got == want


def test_flux_spec_drops_guidance_only_when_asked():
    with_g = _flat(T.flux_shape_spec(T.TinyFluxDims()))
    without = _flat(T.flux_shape_spec(T.TinyFluxDims(), guidance=False))
    assert sorted(set(with_g) - set(without)) == [
        "guidance_in.in_layer.bias", "guidance_in.in_layer.weight",
        "guidance_in.out_layer.bias", "guidance_in.out_layer.weight"]
