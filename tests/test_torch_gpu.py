"""The hand CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the reference package, so on the machine
with the card it runs without them:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.kernels import ops, ref

SIZING_TOL = dict(rtol=1e-5, atol=1e-7)      # tests/test_sizing.py
INTERP_TOL = dict(atol=2e-5, rtol=1e-4)      # tests/test_kernels.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed, dev):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,c_max", [(1, 2, 1), (33, 6, 8), (64, 10, 6),
                                       (100, 32, 3), (196_608, 8, 2)])
def test_sizing_latency_kernel_on_card(cuda, B, K, c_max):
    g = _gen(B + K, cuda)
    mu = 5.0 + 55.0 * torch.rand((B, K), generator=g, device=cuda)
    repl = torch.randint(1, c_max + 1, (B, K), generator=g,
                         device=cuda).float()
    lam = (0.05 + 1.15 * torch.rand((B, K), generator=g, device=cuda)) \
        * mu * repl
    w = 2.0 * torch.rand((B, K), generator=g, device=cuda)
    adj = torch.triu(torch.rand((K, K), generator=g, device=cuda) < 0.4, 1)
    n0 = ops.LAUNCHES["sizing_latency"]
    got = ops.sizing_latency(lam, mu, repl, w, adj, c_max=c_max)
    want = ref.sizing_latency_ref(lam, mu, repl, w, adj, c_max=c_max)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sizing_latency"] == n0 + 1
    torch.testing.assert_close(got[0], want[0], **SIZING_TOL)
    torch.testing.assert_close(got[1], want[1], **SIZING_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["idw", "rbf"])
@pytest.mark.parametrize("Q,M,F", [(5, 3, 7), (300, 37, 9), (130, 256, 130),
                                   (8192, 1024, 16), (64, 3000, 16)])
def test_fused_interp_kernel_on_card(cuda, kind, Q, M, F):
    g = _gen(Q + M + F, cuda)
    xq = torch.randn((Q, F), generator=g, device=cuda)
    xm = torch.randn((M, F), generator=g, device=cuda)
    y = torch.randn((M,), generator=g, device=cuda)
    w = 0.1 + 0.9 * torch.rand((M,), generator=g, device=cuda)
    n0 = ops.LAUNCHES["fused_interp"]
    got = ops.fused_interp(xq, xm, y, w, kind=kind)
    want = ref.fused_interp_ref(xq, xm, y, w, kind=kind)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_interp"] == n0 + 1
    torch.testing.assert_close(got[0], want[0], **INTERP_TOL)
    torch.testing.assert_close(got[1], want[1], **INTERP_TOL)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.fused_interp(x.double(), x.double(), x[:, 0], x[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_interp(x.T.contiguous().T, x, x[:, 0].contiguous(),
                         x[:, 0].contiguous())
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.fused_interp(x, x.cpu(), x[:, 0], x[:, 0])
