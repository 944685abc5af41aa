"""The frozen kernel-name map the traced runs read."""

import pytest

import _paths  # noqa: F401
import families

CASES = [
    ("void qmm_wgmma_kernel<true, 2, 1, false>(Params)", "kernel",
     "K1/K2 qmm (wgmma)", "linear"),
    ("void qmm_smallm_kernel<true, 4>(Params)", "kernel",
     "K1/K2 qmm (split-K)", "linear"),
    ("void gemm_wgmma_kernel<256>(GemmParams)", "kernel", "K4 i8mm",
     "linear"),
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NNT", "kernel",
     "dense GEMM (cuBLAS)", "linear"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "kernel", "dense GEMM (cuBLAS)", "linear"),
    ("void flash_fwd_kernel<128, 128, 64>(FlashParams)", "kernel",
     "K7 flash_attn", "attention"),
    ("void i8attn_kernel<128, true>(I8Params)", "kernel", "K6 i8attn",
     "attention"),
    ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", "kernel",
     "library attention", "attention"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_ndhwc_kernel",
     "kernel", "convolution", "conv"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<c10::BFloat16>>", "kernel",
     "elementwise/reduce", "torch_ops"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel",
     "kernel", "elementwise/reduce", "torch_ops"),
    ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", "copy/memcpy",
     "torch_ops"),
    ("Memset (Device)", "gpu_memset", "memset", "torch_ops"),
    ("void at::native::index_elementwise_kernel_rope", "kernel",
     "elementwise/reduce", "torch_ops"),
    ("triton_poi_fused_mul_0", "kernel", "other", "torch_ops"),
]


@pytest.mark.parametrize("name,cat,fam,cls", CASES)
def test_family_and_class(name, cat, fam, cls):
    assert families.family(name, cat) == fam
    assert families.klass(fam) == cls
