"""The port's flash-attention op (``repro_torch.kernels.flash_attention``)
against the reference's.

On the CPU the op takes its plain PyTorch version, which must reproduce
both the reference op on its ``interpret`` backend (the Pallas kernel
under the interpreter) and the reference oracle ``attention_ref``, at the
shapes and tolerances of ``tests/test_kernels.py`` (2e-5 in float32, 2e-2
in bfloat16), plus a bidirectional dh = 80 case and a window at a ragged
length.  A bidirectional case at a ragged length is held against the
oracle only: the reference op pads Skv to its block and masks kv padding
by the padded length, so without a causal mask its Pallas route attends
to the zero-padded keys (ROADMAP.md §3).  The CUDA kernel runs only on
the card: ``chip_smoke.py`` holds it against the same plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import flash_attention

torch.set_num_threads(2)

# (b, hq, hkv, s, dh, causal, window, dtype): tests/test_kernels.py's six,
# then a bidirectional dh = 80 case and a window at a ragged length
CASES = [
    (2, 4, 2, 256, 64, True, None, "float32"),
    (1, 8, 8, 128, 64, False, None, "float32"),
    (2, 4, 1, 200, 80, True, None, "float32"),
    (1, 4, 2, 256, 64, True, 64, "float32"),
    (1, 2, 2, 96, 128, True, None, "float32"),
    (1, 4, 2, 128, 64, True, None, "bfloat16"),
    (1, 4, 4, 256, 80, False, None, "float32"),
    (1, 4, 2, 201, 64, True, 48, "bfloat16"),
]


def _inputs(b, hq, hkv, s, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((b, hq, s, dh), (b, hkv, s, dh), (b, hkv, s, dh))]


def _as_dtype(arrays, dtype):
    """The same values in both packages: rounded to bf16 once, by torch."""
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    js = [jnp.asarray(t.to(torch.float32).numpy(), getattr(jnp, dtype))
          for t in ts]
    return ts, js


@pytest.mark.parametrize("b,hq,hkv,s,dh,causal,win,dtype", CASES)
def test_plain_matches_reference_op_and_oracle(b, hq, hkv, s, dh, causal,
                                               win, dtype):
    ts, js = _as_dtype(_inputs(b, hq, hkv, s, dh, dtype), dtype)
    got = flash_attention(*ts, causal=causal, window=win)
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    got = got.to(torch.float32).numpy()
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in (jflash(*js, causal=causal, window=win, backend="interpret"),
                 jref(*js, causal=causal, window=win)):
        err = np.abs(got - np.asarray(want, np.float32)).max()
        assert err < tol, err


def test_bidirectional_ragged_length_matches_oracle():
    ts, js = _as_dtype(_inputs(1, 4, 4, 150, 80, "float32"), "float32")
    got = flash_attention(*ts, causal=False).numpy()
    want = np.asarray(jref(*js, causal=False))
    assert np.abs(got - want).max() < 2e-5
    # the reference's Pallas route differs here: it attends to its padding
    padded = np.asarray(jflash(*js, causal=False, backend="interpret"))
    assert np.abs(padded - want).max() > 1e-2


def test_scale_and_unequal_lengths_match_oracle():
    """An explicit scale, and Sq != Skv (rows and cols both count from 0,
    as in the reference)."""
    q, _, _ = _inputs(1, 4, 2, 40, 32, "float32")
    _, k, v = _inputs(1, 4, 2, 70, 32, "float32", seed=1)
    for causal in (True, False):
        got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, scale=0.3)
        want = jref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                    scale=0.3)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-5


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        flash_attention(q.to(torch.bfloat16), kv, kv)
    with pytest.raises(TypeError):
        flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(torch.zeros(1, 3, 8, 16), kv, kv)
    with pytest.raises(ValueError, match="head_dim 320 > 256"):
        flash_attention(torch.zeros(1, 4, 8, 320), torch.zeros(1, 2, 8, 320),
                        torch.zeros(1, 2, 8, 320))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(torch.zeros(1, 8, 4, 16).transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="does not match"):
        flash_attention(q, torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv.to("meta"))
