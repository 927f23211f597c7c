"""The port's profiling module on the CPU: the kernel groups and ``op_report`` over
a CPU-only ``torch.profiler`` profile (the host spans: ``test_torch_tracing.py``)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from minsdtf_tpu_torch import profiling


@pytest.mark.parametrize("name,group", [
    ("void flash_bf16_kernel<40, 0>(Params)", "attention K1/K2"),
    ("flash_online_d512_merge_kernel", "attention K1/K2"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", "convolution"),
    ("nvjet_tst_128x64_64x4_1x2_h_bz_coopA_TNN", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16>"
     "(cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16::Params)", "int8 gemm"),
    ("void at::native::RowwiseMomentsCUDAKernel<float>", "elementwise/other"),
    ("void at::native::vectorized_layer_norm_kernel<float, float>", "norm"),
    ("Memcpy HtoD (Pinned -> Device)", "memcpy/memset"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel", "elementwise/other"),
])
def test_kernel_group(name, group):
    assert profiling.kernel_group(name) == group


def test_op_report_buckets_a_cpu_profile(capsys):
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.relu(torch.matmul(a, b))
    by_name = profiling.op_report(prof, device="cpu", top=5)
    assert by_name["aten::relu"][1] == 3 and by_name["aten::matmul"][1] == 3
    assert list(by_name.values()) == sorted(by_name.values(), key=lambda v: -v[0])
    assert "cpu time total" in capsys.readouterr().out
    by_group = profiling.op_report(prof, by="group", device="cpu", top=None)
    assert by_group["gemm"][1] == 3  # aten::matmul
    assert sum(n for _, n in by_group.values()) == sum(n for _, n in by_name.values())
    assert profiling.op_report(prof, top=None) == {}  # no device events in a CPU profile
    with pytest.raises(ValueError, match="by must be"):
        profiling.op_report(prof, by="source")
