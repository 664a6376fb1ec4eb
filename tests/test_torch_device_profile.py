"""The port's device profile (horovod_tpu_torch/profiler/device_profile.py).

`classify` over a fixed list of CUDA kernel names as torch.profiler
reports them on an H100 (cuDNN, cuBLAS's nvjet and cutlass GEMMs, NCCL,
PyTorch's elementwise, reduce, copy and pooling kernels, the port's own
`hvd` kernels); the aggregate and its markdown on synthetic events,
the table laid out as the JAX package's `DeviceProfile` lays it out;
and `profile_step` on the CPU raising that the trace holds no device
event. The capture on the card runs in chip_smoke.py phase 9.
"""

import os
import threading
import time

import pytest
import torch

from horovod_tpu.profiler import device_profile as jdp
from horovod_tpu_torch.profiler import device_profile as tdp

NAMES = [
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective"),
    ("void hvd::cbh::dw_hopper<true, 256, 128>(CUtensorMap_st, "
     "CUtensorMap_st, ...)", "hvd kernel"),
    ("void hvd::flash::dq_hopper<128>(...)", "hvd kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__"
     "5x_cudnn", "convolution/custom-call"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64", "convolution/custom-call"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16>",
     "convolution/custom-call"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_"
     "bf16_64x64_32x6_tn_align8>(...)", "matmul"),
    ("ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_stages_32x6_tn",
     "matmul"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor>>>",
     "reduce fusion (stats/grads)"),
    ("void at::native::elementwise_kernel<128, 4, at::native::"
     "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(...)>>",
     "layout/copy"),
    ("Memcpy HtoD (Pinned -> Device)", "layout/copy"),
    ("Memset (Device)", "layout/copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<c10::BFloat16>, ...>", "fused elementwise/compute"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "MulFunctor<float>, ...>", "fused elementwise/compute"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc"
     "<c10::BFloat16, float>(...)", "pool forward"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nhwc"
     "<c10::BFloat16, float>(...)", "maxpool backward"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
     "float, float, float, at::native::(anonymous namespace)::"
     "LogSoftMaxForwardEpilogue>", "other"),
    ("void at::native::index_elementwise_kernel<128, 4, ...>",
     "fused elementwise/compute"),
    ("void multi_tensor_apply_kernel<TensorListMetadata<3>, "
     "FusedSgdMathFunctor<float>>", "other"),
]


@pytest.mark.parametrize("name,cat", NAMES, ids=[c for _, c in NAMES])
def test_classify_cuda_kernel_names(name, cat):
    assert tdp.classify(name) == cat


def test_classify_custom_buckets_and_other():
    assert tdp.classify("my_kernel", [(r"^my_", "mine")]) == "mine"
    assert tdp.classify("something_else") == "other"


def _events():
    """(name, start µs, end µs) over 3 reps: a conv 2.0 ms a step, a
    max-pool backward 0.5, six memcpys of 0.1 (0.2 a step)."""
    ev, t = [], 0.0
    for name, dur_ms, n in (("sm90_xmma_fprop_implicit_gemm_x_cudnn", 2.0,
                             3),
                            ("max_pool_backward_nhwc", 0.5, 3),
                            ("Memcpy DtoD (Device -> Device)", 0.1, 6)):
        for _ in range(n):
            ev.append((name, t, t + dur_ms * 1e3))
            t += dur_ms * 1e3 + 5.0
    return ev


def test_aggregate_per_op_and_category():
    prof = tdp.aggregate(_events(), reps=3)
    assert prof.per_op["sm90_xmma_fprop_implicit_gemm_x_cudnn"] == \
        pytest.approx(2.0)
    assert prof.per_op["max_pool_backward_nhwc"] == pytest.approx(0.5)
    assert prof.per_op["Memcpy DtoD (Device -> Device)"] == \
        pytest.approx(0.2)
    assert prof.total_ms == pytest.approx(2.7)
    assert prof.per_category == pytest.approx(
        {"convolution/custom-call": 2.0, "maxpool backward": 0.5,
         "layout/copy": 0.2})
    assert prof.reps == 3


def test_markdown_like_jax():
    """The same per-op and per-category tables print as the JAX
    package's DeviceProfile prints them."""
    prof = tdp.aggregate(_events(), reps=3)
    ref = jdp.DeviceProfile(per_op=dict(prof.per_op),
                            per_category=dict(prof.per_category),
                            total_ms=prof.total_ms, reps=prof.reps)
    assert prof.as_markdown(top=2) == ref.as_markdown(top=2)
    assert prof.top_ops(3) == ref.top_ops(3)
    md = prof.as_markdown(top=2)
    assert "| convolution/custom-call | 2.00 |" in md
    assert md.count("| `") == 2
    assert prof.top_ops(1)[0][0] == "sm90_xmma_fprop_implicit_gemm_x_cudnn"


def test_profile_step_on_the_cpu_raises():
    calls = []

    def run_once():
        calls.append(1)
        return torch.ones(8) * 2

    with pytest.raises(RuntimeError, match="no device events"):
        tdp.profile_step(run_once, reps=2, warmup=1)
    assert len(calls) == 3


def test_kernel_events_skip_host_events():
    """A CPU-only trace has host events and no device event."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert len(prof.events()) > 0
    assert tdp.kernel_events(prof) == []


def test_on_demand_capture_stops_after_its_steps(tmp_path):
    """The capture runs on its own thread, stops once the step counter
    has moved by `steps`, writes its trace, and refuses a second capture
    while one runs."""
    steps = [0]
    go = threading.Event()

    def count():
        go.set()
        return steps[0]

    assert tdp.start_on_demand_capture(str(tmp_path), steps=2,
                                       step_count_fn=count, timeout_s=30)
    assert go.wait(timeout=30)
    assert tdp.capture_active()
    assert not tdp.start_on_demand_capture(str(tmp_path))
    steps[0] = 2
    deadline = time.monotonic() + 30
    while tdp.capture_active() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not tdp.capture_active()
    assert [f for f in os.listdir(tmp_path) if f.startswith("devprof.")]
