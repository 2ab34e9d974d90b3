"""Port parity for the dense prefill attention (ops/attention.py): K14's
plain version against the stock Pallas TPU flash kernel itself, the
page-view route (K8) against the JAX package's, the masked fallback, and
the routing of causal_self_attention at every branch of _flash_available.

The stock kernel runs on the CPU through
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()`` with
``interpret=False``, so JAX's causal_self_attention takes its flash route
(on the CPU it would otherwise take the masked reference). Inputs are
seeded numpy arrays handed to both. Tolerance 2e-2 (rtol and atol), that
of tests/test_dense_prefill_flash.py: both sides round the softmax's p to
bf16 before p·v (the kernel against its running max, the plain version
against the row's final max) and round the output to bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mixq_tensorrt_llm_tpu.ops import attention as jattn
from mixq_tensorrt_llm_tpu_torch.ops import attention as tattn
from mixq_tensorrt_llm_tpu_torch.ops import ref as tref

TOL = 2e-2


def qkv(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("b,s,h,d", [(1, 256, 2, 128), (2, 512, 2, 64),
                                     (1, 128, 1, 256)])
def test_plain_flash_matches_stock_pallas_kernel(b, s, h, d):
    q, k, v = qkv(b * s + d, b, s, h, h, d)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jattn.causal_self_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), scale,
                                           interpret=False)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tattn.flash_causal_attention(tq, tk, tv, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, d)
    close(got.float(), want)
    # the route: causal_self_attention casts in and out as JAX's does
    via = tattn.causal_self_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), scale)
    assert via.dtype == torch.float32
    assert torch.equal(via, got.float())


def test_plain_flash_is_causal_and_scaled():
    """Row r of the plain version sees keys 0..r only, with the scale on
    the logits: against a per-row f32 softmax."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in qkv(9, 1, 40, 2, 2, 16))
    got = tref.flash_causal_attention(q, k, v, 0.3).float()
    for r in (0, 7, 39):
        lg = torch.einsum("hd,khd->hk", q[0, r].float(),
                          k[0, :r + 1].float()) * 0.3
        want = torch.einsum("hk,khd->hd", torch.softmax(lg, -1),
                            v[0, :r + 1].float())
        assert float((got[0, r] - want).abs().max()) < TOL


@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (4, 1)])
def test_page_view_gqa_matches_jax(hq, hkv):
    b, s, d = 2, 256, 64
    q, k, v = qkv(hq * 10 + hkv, b, s, hq, hkv, d)
    scale = d ** -0.5
    want = jattn._flash_prefill_page_view(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), scale, 0, 0)
    got = tattn._flash_prefill_page_view(
        *(torch.from_numpy(x) for x in (q, k, v)), scale, 0, 0)
    assert got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("window,sink", [(64, 0), (64, 16), (128, 4)])
def test_page_view_window_matches_jax(window, sink):
    b, s, hq, hkv, d = 1, 256, 4, 2, 64
    q, k, v = qkv(window + sink, b, s, hq, hkv, d)
    scale = d ** -0.5
    want = jattn._flash_prefill_page_view(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), scale, window,
                                          sink)
    got = tattn._flash_prefill_page_view(
        *(torch.from_numpy(x) for x in (q, k, v)), scale, window, sink)
    close(got, want)


def test_masked_fallback_with_window_matches_jax():
    """S = 48 is no flash shape: the masked einsum, window 16 and 4 sinks
    (test_dense_prefill_flash.py's fallback case)."""
    q, k, v = qkv(5, 1, 48, 2, 2, 32)
    scale = 32 ** -0.5
    want = jattn.causal_self_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale, window=16,
                                       sink=4)
    got = tattn.causal_self_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), scale, window=16, sink=4)
    close(got, want)


@pytest.mark.parametrize("s", [100, 127, 128, 384])
@pytest.mark.parametrize("d", [32, 64, 128, 256, 512])
def test_flash_available_as_jax(s, d):
    assert tattn._flash_available(s, d) == jattn._flash_available(s, d)


@pytest.mark.parametrize("s,d,hq,hkv,window,route", [
    (256, 64, 2, 2, 0, "flash"),        # MHA, flash shape
    (128, 256, 1, 1, 0, "flash"),
    (256, 64, 4, 2, 0, "page_view"),    # GQA
    (256, 64, 2, 2, 32, "page_view"),   # window
    (100, 64, 2, 2, 0, "masked"),       # S not a multiple of 128
    (64, 64, 2, 2, 0, "masked"),        # S < 128
    (256, 96, 2, 2, 0, "masked"),       # head_dim the kernel does not take
    (48, 32, 4, 2, 16, "masked"),       # GQA and window, no flash shape
])
def test_routing(monkeypatch, s, d, hq, hkv, window, route):
    """Each branch of causal_self_attention takes its route, on the CPU as
    on the card."""
    seen = []
    for name, mod, attr in (("flash", tattn, "flash_causal_attention"),
                            ("page_view", tattn, "_flash_prefill_page_view"),
                            ("masked", tref, "attention")):
        real = getattr(mod, attr)

        def spy(*a, _real=real, _name=name, **k):
            seen.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, attr, spy)
    q, k, v = (torch.from_numpy(x) for x in qkv(0, 1, s, hq, hkv, d))
    out = tattn.causal_self_attention(q, k, v, d ** -0.5, window=window)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    # the page view's plain K8 calls ref.attention in turn
    assert seen[0] == route and (route == "page_view" or len(seen) == 1)


def test_page_view_takes_largest_page_the_kernel_allows(monkeypatch):
    """The view's page size is the largest multiple of 16 up to 256 that
    divides S (K8's limits; JAX's Pallas kernel goes to 512), and the
    pages are contiguous bf16, as K8 takes them on the card."""
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    sizes = []
    real = pa.paged_prefill_attention

    def spy(q, kp, vp, *a, **k):
        assert kp.is_contiguous() and vp.is_contiguous()
        assert kp.dtype == vp.dtype == torch.bfloat16
        sizes.append(kp.shape[2])
        return real(q, kp, vp, *a, **k)
    monkeypatch.setattr(pa, "paged_prefill_attention", spy)
    for s in (128, 384, 768, 1024):
        q, k, v = (torch.from_numpy(x) for x in qkv(1, 1, s, 4, 2, 64))
        tattn._flash_prefill_page_view(q, k, v, 0.125, 0, 0)
    assert sizes == [128, 192, 256, 256]


def test_flash_wrapper_on_cpu_launches_nothing():
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    before = dict(_build.LAUNCHES)
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in qkv(2, 1, 128, 2, 2, 64))
    tattn.flash_causal_attention(q, k, v, 0.125)
    assert _build.LAUNCHES == before
