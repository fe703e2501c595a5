"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These need a CUDA device and nvcc (a CUDA kernel has no CPU mode), so they
carry the ``torch_port`` marker and skip without a card. The file imports
neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m torch_port -q

Tolerances: bf16 outputs at 2e-2 (the kernel rounds p to bf16 against its
running row max, the plain version against the final max; a few bf16 ulps),
f32 log-sum-exp at 1e-3 (scaling before or after the q.k product, and the
sums' order).
"""

import pytest

torch = pytest.importorskip("torch")

from ditl_tpu_torch.ops import flash_attention as tfa  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, b, s_q, s_kv, h, kv, d, lengths=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16()
               for shape in ((b, s_q, h, d), (b, s_kv, kv, d), (b, s_kv, kv, d)))
    seg = None
    if lengths is not None:
        pos = torch.arange(s_q, device=cuda)
        seg = (pos[None] < torch.tensor(lengths, device=cuda)[:, None]).int().contiguous()
    return q, k, v, seg


@pytest.mark.torch_port
@pytest.mark.parametrize("b,s_q,s_kv,h,kv,d,causal,lengths", [
    (4, 512, 512, 32, 8, 128, True, [512, 401, 230, 97]),  # serving prefill
    (2, 200, 333, 8, 2, 64, False, None),  # ragged, non-causal
    (1, 130, 130, 4, 4, 32, True, None),  # head_dim 32, MHA
])
def test_flash_fwd_kernel_matches_plain(cuda, b, s_q, s_kv, h, kv, d, causal, lengths):
    q, k, v, seg = _inputs(cuda, b, s_q, s_kv, h, kv, d, lengths)
    tfa.reset_launches()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    assert tfa.launches == 1
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-3)


@pytest.mark.torch_port
def test_flash_fwd_kernel_raises_instead_of_falling_back(cuda):
    """On CUDA tensors the wrapper launches the kernel or raises: no plain
    fallback for shapes or dtypes the kernel does not take."""
    q, k, v, _ = _inputs(cuda, 1, 64, 64, 4, 2, 128)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q.float(), k.float(), v.float())
    q48, k48, v48, _ = _inputs(cuda, 1, 64, 64, 4, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q48, k48, v48)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    assert tfa.launches == 0
