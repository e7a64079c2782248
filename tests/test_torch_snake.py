"""Kernel G (DAC's Snake, ``csrc/snake.cu``) on the CPU: its backward in
torch against autograd of the plain expression, the routing of
``models.dac.snake`` (only fp32 on the card takes the kernel), the wrappers'
plain versions and checks, and the launch plan, with the kernel's segment
arithmetic replayed over every element. The kernel itself runs only on the
card (``test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu_torch import _build
from audiotools_tpu_torch.models import dac as PD
from audiotools_tpu_torch.ops import hopper_kernels as HK

SHAPES = [(2, 3, 37), (1, 1, 61), (3, 1, 1030), (2, 5, 513)]


def _inputs(shape, alpha, dtype=torch.float64, seed=0):
    rng = np.random.RandomState(seed)
    B, C, T = shape
    x = torch.from_numpy(rng.randn(*shape) * 0.7).to(dtype)
    # one alpha a channel around the case's value
    a = torch.from_numpy(alpha * np.exp(rng.uniform(-0.2, 0.2, (1, C, 1)))).to(dtype)
    g = torch.from_numpy(rng.randn(*shape)).to(dtype)
    return x, a, g


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", [0.3, 1.0, 5.0])
def test_snake_backward_plain_is_autograd_of_snake_plain(shape, alpha):
    """The kernel's derivative written in torch equals autograd's gradients
    of the eager expression in float64, for x and for alpha, at T not a
    multiple of 4 and at one channel."""
    x, a, g = _inputs(shape, alpha)
    x.requires_grad_(True)
    a.requires_grad_(True)
    want_x, want_a = torch.autograd.grad(HK.snake_plain(x, a), (x, a), g)
    got_x, got_a = HK.snake_backward_plain(x.detach(), a.detach(), g)
    assert got_a.shape == a.shape
    torch.testing.assert_close(got_x, want_x, rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(got_a, want_a, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_snake_off_the_card_runs_the_expression_and_launches_nothing(dtype):
    """On the CPU, in every dtype, ``models.dac.snake`` and the ``Snake``
    module, forward and backward, are the eager expression: no kernel
    launch is counted."""
    x, a, g = _inputs((2, 4, 99), 1.0, dtype=dtype, seed=1)
    before = dict(HK.LAUNCHES)
    torch.testing.assert_close(PD.snake(x, a), x + (1.0 / (a + 1e-9)) * torch.sin(a * x) ** 2,
                               rtol=0, atol=0)
    layer = PD.Snake(4).to(dtype)
    with torch.no_grad():
        layer.alpha.copy_(a)
    xr, ar = x.clone().requires_grad_(True), a.clone().requires_grad_(True)
    layer(xr).backward(g)
    want_x, want_a = torch.autograd.grad(HK.snake_plain(xr, ar), (xr, ar), g)
    assert torch.equal(xr.grad, want_x)
    assert torch.equal(layer.alpha.grad, want_a)
    assert HK.LAUNCHES == before


@pytest.mark.parametrize("shape", SHAPES)
def test_snake_wrappers_on_the_cpu_are_their_plain_versions(shape):
    x, a, g = _inputs(shape, 1.0, dtype=torch.float32, seed=2)
    before = dict(HK.LAUNCHES)
    assert torch.equal(HK.snake(x, a), HK.snake_plain(x, a))
    for got, want in zip(HK.snake_backward(x, a, g), HK.snake_backward_plain(x, a, g)):
        assert torch.equal(got, want)
    assert HK.LAUNCHES == before


def test_snake_off_the_cpu_checks_then_reaches_the_kernel_or_raises(monkeypatch):
    """Off the CPU the wrappers check shapes and types, never run their
    plain versions, and raise where no kernel can be launched."""
    monkeypatch.setattr(HK, "snake_plain", lambda *a: pytest.fail("plain version ran"))
    monkeypatch.setattr(HK, "snake_backward_plain", lambda *a: pytest.fail("plain version ran"))
    meta = {"device": "meta"}
    x, a = torch.empty(2, 3, 40, **meta), torch.empty(1, 3, 1, **meta)
    with pytest.raises(ValueError, match="expected x"):
        HK.snake(torch.empty(3, 40, **meta), a)
    with pytest.raises(ValueError, match="expected x"):
        HK.snake(x, torch.empty(1, 4, 1, **meta))
    with pytest.raises(TypeError, match="float32"):
        HK.snake(x.double(), a.double())
    with pytest.raises(ValueError, match="expected x"):
        HK.snake_backward(x, a, torch.empty(2, 3, 41, **meta))

    class _Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "library", lambda name: _Lib())
    for call in (lambda: HK.snake(x, a), lambda: HK.snake_backward(x, a, x)):
        with pytest.raises(RuntimeError, match="expected CUDA tensors"):
            call()


# -- the launch plan, and the kernel's segments replayed ----------------------


PLAN_CASES = [(1, 1), (1, 511), (1, 512), (1, 513), (96, 1_323_008), (18 * 1536, 33),
              (18 * 64, 16_896), (7, 1031), (1024 * 18, 264)]


@pytest.mark.parametrize("rows,T", PLAN_CASES)
def test_snake_plan_gives_each_segment_one_warp(rows, T):
    plan = HK.snake_plan(rows, T)
    geometry = _build.DEFINES["snake"]
    warps = plan.threads // 32
    assert plan.threads == geometry["SNAKE_THREADS"] and plan.threads % 32 == 0
    assert plan.segment == 128 * geometry["SNAKE_UNROLL"]
    assert (plan.n_seg - 1) * plan.segment < T <= plan.n_seg * plan.segment
    assert (plan.blocks - 1) * warps < rows * plan.n_seg <= plan.blocks * warps
    assert plan.blocks < 2 ** 31


def _replay_segments(B, C, T, offset, same_alignment, plan):
    """``csrc/snake.cu``'s segments of a ``(B, C, T)`` tensor that starts
    ``offset`` floats past a 16-byte boundary: how often each element is
    visited, whether every vector access is 16-byte aligned, and the most
    vectors a lane takes."""
    visits = np.zeros(B * C * T, dtype=np.int64)
    aligned, most = True, 0
    for row in range(B * C):
        for seg in range(plan.n_seg):
            start = seg * plan.segment
            base = row * T + start
            n = min(plan.segment, T - start)
            head = min((4 - (offset + base) % 4) % 4, n) if same_alignment else n
            n_vec = (n - head) // 4
            most = max(most, -(-n_vec // 32))
            visits[base: base + head] += 1
            vec = base + head
            aligned &= (offset + vec) % 4 == 0 or n_vec == 0
            visits[vec: vec + 4 * n_vec] += 1
            visits[vec + 4 * n_vec: base + n] += 1
    return visits, aligned, most


@pytest.mark.parametrize("same_alignment", [True, False])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 3, 37), (1, 2, 1030), (2, 1, 2051), (1, 1, 4)])
def test_snake_segments_visit_every_element_once(shape, offset, same_alignment):
    B, C, T = shape
    plan = HK.snake_plan(B * C, T)
    visits, aligned, most = _replay_segments(B, C, T, offset, same_alignment, plan)
    assert (visits == 1).all()
    assert aligned
    assert most <= _build.DEFINES["snake"]["SNAKE_UNROLL"]


def test_snake_work_at_the_codec_and_training_shapes():
    """Forward 8 bytes an element, backward 12 plus each segment's two
    partial sums, from meta tensors."""
    meta = {"device": "meta"}
    for B, C, T in ((1, 96, 1_323_008), (18, 64, 16_896)):
        x, a = torch.empty(B, C, T, **meta), torch.empty(1, C, 1, **meta)
        n = B * C * T
        n_seg = HK.snake_plan(B * C, T).n_seg
        assert HK.snake.work(x, a) == {"flops": 5.0 * n, "bytes": 4.0 * (2 * n + C)}
        assert HK.snake_backward.work(x, a, x) == {
            "flops": 13.0 * n, "bytes": 4.0 * (3 * n + 2 * C + 4 * B * C * n_seg)}
