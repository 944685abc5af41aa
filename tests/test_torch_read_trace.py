"""The trace reader of the port (tools/read_trace.py): the kernel-family
map on real kernel names, and the summaries on a trace made on the CPU.

A CPU trace holds CPU operator events only: ``summarize`` and
``module_ms`` read them through their ``cats`` argument (``cpu_op``
standing in for the card's ``kernel`` events, ``user_annotation`` for
``gpu_user_annotation``). On the card they read the device categories, as
``chip_smoke.py`` phase 21 does."""

import contextlib
import io
import json

import pytest
import torch

from comfyui_gguf_tpu_torch import observability
from comfyui_gguf_tpu_torch.tools import read_trace

# kernel names as the profiler reports them on the H100 (demangled): the
# port's kernels, and PyTorch's cuBLAS and elementwise kernels
NAMES = [
    ("void qmm_wgmma_kernel<true, false, 2, false, false, false, false>"
     "(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float const*, "
     "__nv_bfloat16*, int, int, int, int, float, int)",
     "K1/K2 qmm (wgmma)", "K1 qmm (wgmma)"),
    ("void qmm_wgmma_kernel<false, false, 1, false, false, true, false>"
     "(CUtensorMap, ...)", "K1/K2 qmm (wgmma)", "K2 qmm (wgmma)"),
    ("void qmm_smallm_kernel<true, true, false, false, 0>(__nv_bfloat16 "
     "const*, unsigned char const*, void const*, ...)",
     "K1/K2 qmm (split-K)", "K1 qmm (split-K)"),
    ("_Z17qmm_smallm_kernelILb0ELb0ELb0ELb0ELi0EEvPK13__nv_bfloat16",
     "K1/K2 qmm (split-K)", "K2 qmm (split-K)"),
    ("void qmm_simt_kernel<true, true, false, false>(float const*, ...)",
     "K1/K2 qmm (f32 SIMT)", "K1 qmm (f32 SIMT)"),
    ("void gemm_wgmma_kernel<1, 256, false>(CUtensorMap, CUtensorMap)",
     "K4 i8mm", "K4 i8mm"),
    ("void flash_fwd_kernel<128, 64>(CUtensorMap, CUtensorMap, float)",
     "K7 flash_attn", "K7 flash_attn"),
    ("void i8attn_kernel<128, true>(CUtensorMap, CUtensorMap)",
     "K6 i8attn", "K6 i8attn"),
    ("prep_reduce_kernel(PrepArgs)", "K6 prep", "K6 prep"),
    ("void prep_quant_wide_kernel<256>(PrepArgs)", "K6 prep", "K6 prep"),
    ("prep_fold_kernel(PrepArgs)", "K6 prep", "K6 prep"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroup"
     "size1x1x1_execute_segment_k_off_kernel__5x_cublas",
     "dense GEMM (cuBLAS)", "dense GEMM (cuBLAS)"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16"
     "_16x16_128x2_tn_align8>(Params)", "dense GEMM (cuBLAS)",
     "dense GEMM (cuBLAS)"),
    ("void gemv2T_kernel_val<int, int, __nv_bfloat16, float, 128>(...)",
     "dense GEMM (cuBLAS)", "dense GEMM (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3> >"
     "(int, at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, "
     "3>)", "elementwise/reduce", "elementwise/reduce"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, "
     "float, 4> >(...)", "elementwise/reduce", "elementwise/reduce"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<c10::BFloat16, float>(int, float, ...)", "elementwise/reduce",
     "elementwise/reduce"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>(...)",
     "copy/memcpy", "copy/memcpy"),
    ("Memcpy DtoD (Device -> Device)", "copy/memcpy", "copy/memcpy"),
    ("Memset (Device)", "memset", "memset"),
    ("void at::native::index_elementwise_kernel<128, 4>(...)",
     "elementwise/reduce", "elementwise/reduce"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>(...)",
     "other", "other"),
]


@pytest.mark.parametrize("name,family,by_layout", NAMES,
                         ids=[n[0][:40] for n in NAMES])
def test_label_families(name, family, by_layout):
    assert read_trace._label(name) == family
    assert read_trace._label(name, layouts=True) == by_layout


def _traced(tmp_path):
    torch.manual_seed(0)
    x = torch.randn(128, 128)
    with observability.trace(str(tmp_path / "tr")):
        for _ in range(2):
            with observability.annotate("block"):
                y = torch.relu(x @ x)
        with observability.annotate("head"):
            (y.to(torch.float64) + 1).sum()
    return str(tmp_path / "tr" / "trace.json")


def test_summarize_and_module_ms_on_a_cpu_trace(tmp_path):
    path = _traced(tmp_path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    # CPU events stand in for the card's: no device category here
    assert read_trace.summarize(path) == []
    rows = read_trace.summarize(path, top_n=100, cats=("cpu_op",))
    assert sum(r["count"] for r in rows) == len(cpu_ops)
    assert abs(sum(r["share"] for r in rows) - 1.0) < 1e-9
    assert abs(sum(r["ms"] for r in rows)
               - sum(e["dur"] for e in cpu_ops) / 1e3) < 1e-6
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows),
                                             reverse=True)
    fams = {r["op"] for r in rows}
    assert "copy/memcpy" in fams  # aten::copy_ of the float64 cast
    assert fams <= {"copy/memcpy", "elementwise/reduce", "other"}
    # the same directory resolves to its trace
    assert read_trace.summarize(str(tmp_path / "tr"), 100,
                                cats=("cpu_op",)) == rows
    assert len(read_trace.summarize(path, top_n=1, cats=("cpu_op",))) == 1
    mods = read_trace.module_ms(path, cats=("user_annotation",))
    assert set(mods) == {"block", "head"}
    assert mods["block"][1] == 2 and mods["head"][1] == 1
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e3
    for k, (ms, _) in mods.items():
        assert abs(ms - spans[k]) < 1e-9 and ms > 0
    assert read_trace.module_ms(path) == {}


def test_main_prints_the_reference_table_format(tmp_path, monkeypatch):
    path = _traced(tmp_path)
    monkeypatch.setattr(read_trace.summarize, "__defaults__",
                        (20, ("cpu_op",), False))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert read_trace.main([path, "3"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].split() == ["op", "ms", "calls", "share", "example"]
    assert lines[-1].startswith("TOTAL (all ops)")
    assert 2 <= len(lines) <= 5
    with contextlib.redirect_stdout(io.StringIO()):
        assert read_trace.main([]) == 1
