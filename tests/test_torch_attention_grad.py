"""Parity of the port's attention gradient with the reference's, on the CPU.

The same numpy inputs and output gradient go through ``repro`` and
``repro_torch``:
  * ``jax.vjp`` of ``repro.models.layers.sdpa_chunked`` (the custom VJP
    ``_sdpa_flash``, which recomputes the score chunks from ``(m, l)``)
    against torch autograd of ``repro_torch.models.layers.sdpa_chunked``
    (the ``FlashAttention`` Function: ``_sdpa_chunked_raw`` forward with
    its statistics, ``ref.flash_attention_bwd_ref`` backward), with a small
    ``chunk`` on both so that several chunks run and the last is ragged;
  * ``jax.vjp`` of ``sdpa_full`` against torch autograd of ``sdpa_full``
    (the CPU path at S <= 2048, as the reference differentiates it);
  * ``_sdpa_flash_bwd`` itself against ``ref.flash_attention_bwd_ref`` fed
    the same ``(m, l)`` and output;
  * the kernel's statistics convention: ``flash_attention_ref``'s lse
    against the reference's ``m + log l``, and the CPU wrappers
    (``ops.flash_attention(return_stats=True)`` then
    ``ops.flash_attention_bwd``) against autograd.
Cases: causal, windowed and non-causal; GQA and MQA. Levels: 2e-3 at f32
and 2e-2 at bf16 (``tests/test_kernels.py:156``). At bf16 the chunked
gradient and the plain backward are held to the reference's function run
in f32 on the same bf16 values: the reference's bf16 run also rounds its
einsum outputs (scores, dP and each query head's dK/dV partial before the
GQA fold, ``repro/models/layers.py:165-177``) where the port and its
kernel take f32 products, and with 8 query heads a kv head the two bf16
runs differ by up to 0.035 on dV while each lies within 2e-2 of the f32
run (``ROADMAP.md`` Queue 3). ``sdpa_full``'s autodiff rounds alike in
both packages and is held to the reference's bf16 run. The CUDA kernels
are held to ``ref.flash_attention_bwd_ref`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 2b.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from test_torch_round import one_torch_thread  # noqa: F401

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}

# (b, s, h, kv, d, causal, window, chunk, dtype): GQA causal over a ragged
# last chunk, windowed, non-causal, MQA, then bf16
CASES = [(2, 70, 4, 2, 16, True, 0, 32, "f32"),
         (1, 90, 6, 2, 8, True, 20, 32, "f32"),
         (2, 50, 4, 2, 16, False, 0, 16, "f32"),
         (1, 64, 8, 1, 16, True, 0, 24, "f32"),
         (1, 40, 4, 4, 32, False, 9, 16, "f32"),
         (2, 70, 4, 2, 16, True, 0, 32, "bf16"),
         (1, 48, 8, 1, 16, True, 12, 16, "bf16")]


def _tol(name):
    return 2e-2 if name == "bf16" else 2e-3


def _draw(rng, shape, name):
    """numpy normal draws, rounded to the dtype, as (torch, jax) twins."""
    x = rng.normal(size=shape).astype(np.float32)
    tdt, jdt = DTYPES[name]
    xj = jnp.asarray(x).astype(jdt)
    return torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt), xj


def _inputs(b, s, h, kv, d, name, seed):
    rng = np.random.default_rng(seed)
    return [_draw(rng, shape, name) for shape in
            ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d))]


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _torch_grads(fn, q, k, v, dout):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, dout)


def _jax_grads(fn, q, k, v, dout):
    out, vjp = jax.vjp(fn, q, k, v)
    return out, vjp(dout)


def _f32(*xs):
    """The reference's inputs in f32, the same values (see the docstring:
    what a bf16 backward is held to)."""
    return [x.astype(jnp.float32) for x in xs]


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,chunk,name", CASES)
def test_chunked_gradient_matches_the_reference_custom_vjp(
        b, s, h, kv, d, causal, window, chunk, name):
    (qt, qj), (kt, kj), (vt, vj), (dt, dj) = _inputs(b, s, h, kv, d, name,
                                                     seed=s + h)
    out, got = _torch_grads(functools.partial(
        L.sdpa_chunked, causal=causal, window=window, chunk=chunk),
        qt, kt, vt, dt)
    jout, want = _jax_grads(jax.jit(functools.partial(
        jL.sdpa_chunked, causal=causal, window=window, chunk=chunk)),
        *_f32(qj, kj, vj, dj))
    _close(out.detach(), jout, _tol(name))
    for x, y in zip(got, want):
        assert x.dtype == DTYPES[name][0]
        _close(x, y, _tol(name))


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,chunk,name", CASES)
def test_full_gradient_matches_the_reference_autodiff(
        b, s, h, kv, d, causal, window, chunk, name):
    (qt, qj), (kt, kj), (vt, vj), (dt, dj) = _inputs(b, s, h, kv, d, name,
                                                     seed=2 * s + h)
    _, got = _torch_grads(functools.partial(
        L.sdpa_full, causal=causal, window=window), qt, kt, vt, dt)
    _, want = _jax_grads(jax.jit(functools.partial(
        jL.sdpa_full, causal=causal, window=window)), qj, kj, vj, dj)
    for x, y in zip(got, want):
        _close(x, y, _tol(name))


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,chunk,name", CASES)
def test_backward_plain_version_matches_sdpa_flash_bwd(
        b, s, h, kv, d, causal, window, chunk, name):
    """The port of ``_sdpa_flash_bwd`` fed the reference forward's own
    output and ``(m, l)``."""
    (qt, qj), (kt, kj), (vt, vj), (dt, dj) = _inputs(b, s, h, kv, d, name,
                                                     seed=3 * s + h)
    out, m, l = jL._sdpa_chunked_raw(qj, kj, vj, causal=causal,
                                     window=window, chunk=chunk,
                                     return_stats=True)
    want = jL._sdpa_flash_bwd(causal, window, chunk,
                              tuple(_f32(qj, kj, vj, out)) + (m, l),
                              *_f32(dj))
    tdt = DTYPES[name][0]
    got = ref.flash_attention_bwd_ref(
        qt, kt, vt, torch.from_numpy(np.array(out.astype(jnp.float32))
                                     ).to(tdt), dt,
        torch.from_numpy(np.array(m)), torch.from_numpy(np.array(l)),
        causal=causal, window=window, chunk=chunk)
    for x, y in zip(got, want):
        _close(x, y, _tol(name))


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,chunk,name", CASES[:5])
def test_the_kernels_statistics_are_the_references_m_plus_log_l(
        b, s, h, kv, d, causal, window, chunk, name):
    """lse = m + log l, the one number a row the CUDA kernel writes; the
    CPU wrappers' forward-with-statistics and backward give autograd's
    gradient."""
    (qt, qj), (kt, kj), (vt, vj), (dt, _) = _inputs(b, s, h, kv, d, name,
                                                    seed=4 * s + h)
    _, m, l = jL._sdpa_chunked_raw(qj, kj, vj, causal=causal, window=window,
                                   chunk=chunk, return_stats=True)
    out, lse = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                                   return_stats=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    _close(lse, np.asarray(m) + np.log(np.asarray(l)), _tol(name))
    got = ops.flash_attention_bwd(qt, kt, vt, out, dt, lse, causal=causal,
                                  window=window)
    _, want = _torch_grads(functools.partial(
        ref.flash_attention_ref, causal=causal, window=window),
        qt, kt, vt, dt)
    for x, y in zip(got, want):
        _close(x, y.numpy(), _tol(name))


def test_flash_attention_under_grad_on_the_cpu_is_the_plain_version():
    """On CPU tensors ``ops.flash_attention`` under autograd is the plain
    version, differentiated by autograd; no kernel is counted."""
    (qt, _), (kt, _), (vt, _), (dt, _) = _inputs(1, 33, 4, 2, 8, "f32", 5)
    ops.reset_launch_counts()
    _, got = _torch_grads(ops.flash_attention, qt, kt, vt, dt)
    _, want = _torch_grads(ref.flash_attention_ref, qt, kt, vt, dt)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["flash_attention_bwd"] == 0


def test_backward_wrapper_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(1, 5, 4, 8)
    kv = torch.zeros(1, 5, 2, 8)
    lse = torch.zeros(1, 4, 5)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, kv, kv, q, q, lse[:, :, :4])
    with pytest.raises(TypeError):
        ops.flash_attention_bwd(q, kv, kv, q, q, lse.double())
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, kv, kv, q, q.transpose(1, 2), lse)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, kv, kv, q, q, lse, window=-1)
