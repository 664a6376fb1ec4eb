"""The port's FLOPs accounting (horovod_tpu_torch/profiler/flops.py)
against the JAX package's.

Every analytic count equals the JAX function's exactly; the peak and
memory lookups and both env overrides behave as there (ValueError on a
value that is no number), with the port's table naming NVIDIA cards
only; and FlopCounterMode over the port's unfused ResNet-50 forward
(batch 1 at 224², on the CPU) lands within 3% of 2 x RESNET_FWD_GMACS[50]
GFLOP (the constant counts multiply-adds, the counter mul and add
apart, and the constant is rounded to two digits).
"""

import pytest
import torch

from horovod_tpu.profiler import flops as JF
from horovod_tpu_torch.profiler import flops as TF

ENV = ("HOROVOD_BENCH_PEAK_TFLOPS", "HOROVOD_BENCH_HBM_GB",
       "HOROVOD_PERFSCOPE_XLA_FLOPS")


@pytest.fixture()
def clean(monkeypatch):
    for v in ENV:
        monkeypatch.delenv(v, raising=False)


@pytest.mark.parametrize("depth", [50, 101, 152])
@pytest.mark.parametrize("convention", ["macs", "flops"])
def test_resnet_counts_equal_jax(depth, convention):
    assert TF.resnet_train_flops_per_image(depth, convention) == \
        JF.resnet_train_flops_per_image(depth, convention)


@pytest.mark.parametrize("convention", ["macs", "flops"])
def test_inception_and_vgg_counts_equal_jax(convention):
    assert TF.inception_v3_train_flops_per_image(convention) == \
        JF.inception_v3_train_flops_per_image(convention)
    assert TF.vgg16_train_flops_per_image(convention) == \
        JF.vgg16_train_flops_per_image(convention)


def test_unknown_convention_raises_like_jax():
    for mod in (TF, JF):
        with pytest.raises(ValueError, match="unknown FLOPs convention"):
            mod.resnet_train_flops_per_image(50, "bogus")


@pytest.mark.parametrize("dims", [(2048, 8192, 12, 32768, 1024),
                                  (64, 256, 2, 97, 32)])
def test_transformer_counts_equal_jax(dims):
    assert TF.transformer_train_flops_per_token(*dims) == \
        JF.transformer_train_flops_per_token(*dims)
    assert TF.transformer_matmul_params(*dims[:4]) == \
        JF.transformer_matmul_params(*dims[:4])


def test_constants_equal_jax():
    assert TF.RESNET_FWD_GMACS == JF.RESNET_FWD_GMACS
    assert TF.INCEPTION_V3_FWD_GMACS == JF.INCEPTION_V3_FWD_GMACS
    assert TF.VGG16_FWD_GMACS == JF.VGG16_FWD_GMACS
    assert TF.TRAIN_STEP_MULTIPLIER == JF.TRAIN_STEP_MULTIPLIER
    # The port's tables name NVIDIA cards only.
    assert all(k.startswith("NVIDIA ") for k in TF.PEAK_TFLOPS)
    assert set(TF.HBM_GIB) == set(TF.PEAK_TFLOPS)


@pytest.mark.parametrize("name,peak,hbm", [
    ("NVIDIA H100 80GB HBM3", 989e12, 80 << 30),
    ("NVIDIA H100 PCIe", 989e12, 80 << 30),
    ("NVIDIA A100-SXM4-80GB", None, None),
    ("TPU v5 lite", None, None),
])
def test_lookup_by_card_name(clean, name, peak, hbm):
    assert TF.peak_flops_per_chip(name) == peak
    assert TF.hbm_bytes_per_chip(name) == hbm


def test_no_card_no_number(clean):
    """Without a card both packages give None on this host."""
    assert not torch.cuda.is_available()
    assert TF.peak_flops_per_chip() is None is JF.peak_flops_per_chip()
    assert TF.hbm_bytes_per_chip() is None is JF.hbm_bytes_per_chip()


@pytest.mark.parametrize("value", ["123", "0.5", "1e3"])
def test_env_overrides_equal_jax(clean, monkeypatch, value):
    monkeypatch.setenv("HOROVOD_BENCH_PEAK_TFLOPS", value)
    monkeypatch.setenv("HOROVOD_BENCH_HBM_GB", value)
    for name in (None, "NVIDIA H100 80GB HBM3"):
        assert TF.peak_flops_per_chip(name) == JF.peak_flops_per_chip(
            "TPU v5 lite" if name else None) == float(value) * 1e12
        assert TF.hbm_bytes_per_chip(name) == JF.hbm_bytes_per_chip(
            "TPU v5 lite" if name else None)


@pytest.mark.parametrize("knob,fn", [
    ("HOROVOD_BENCH_PEAK_TFLOPS", "peak_flops_per_chip"),
    ("HOROVOD_BENCH_HBM_GB", "hbm_bytes_per_chip")])
def test_env_garbage_raises_like_jax(clean, monkeypatch, knob, fn):
    monkeypatch.setenv(knob, "fast")
    for mod in (TF, JF):
        with pytest.raises(ValueError, match=knob):
            getattr(mod, fn)()


def test_pick_flops_sources():
    """The counted source is tagged "counted" (the JAX package: "xla");
    the rest as there."""
    assert TF.pick_flops(5.0, 3.0) == (5.0, "counted")
    assert JF.pick_flops(5.0, 3.0) == (5.0, "xla")
    for counted, fallback in ((None, 3.0), (0.0, 3.0), (None, None)):
        assert TF.pick_flops(counted, fallback) == \
            JF.pick_flops(counted, fallback)


@pytest.mark.parametrize("value,on", [("0", False), ("", True),
                                      ("1", True), ("no", False)])
def test_counted_gate_reads_like_jax(clean, monkeypatch, value, on):
    monkeypatch.setenv("HOROVOD_PERFSCOPE_XLA_FLOPS", value)
    assert TF.counted_flops_enabled() == JF.xla_flops_enabled() == on


def test_counted_flops_of_a_matmul(clean, monkeypatch):
    a = torch.ones(64, 32)
    b = torch.ones(32, 16)
    assert TF.counted_flops(torch.matmul, a, b) == 2 * 64 * 32 * 16
    monkeypatch.setenv("HOROVOD_PERFSCOPE_XLA_FLOPS", "0")
    assert TF.counted_flops(torch.matmul, a, b) is None


def test_counted_resnet50_forward_within_3pct(clean, monkeypatch):
    """FlopCounterMode on the port's unfused ResNet-50 forward (the
    fused sites' ctypes kernels are invisible to it) against the
    analytic 2 x 4.1 GFLOP an image."""
    monkeypatch.setenv("HOROVOD_CONV_BLOCK", "0")
    monkeypatch.setenv("HOROVOD_FUSE_CONV_BN", "0")
    from horovod_tpu_torch.models import resnet
    torch.manual_seed(0)
    model = resnet.ResNet(depth=50, dtype=torch.float32,
                          device=torch.device("cpu"), seed=0)
    x = torch.randn(1, 224, 224, 3)
    with torch.no_grad():
        got = TF.counted_flops(resnet.apply, model, x, False)
    want = 2 * TF.RESNET_FWD_GMACS[50] * 1e9
    assert abs(got - want) / want < 0.03, (got, want)
