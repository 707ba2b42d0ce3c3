"""Parity of the port's losses and ranking metrics (gigl_tpu_torch.losses)
with the JAX reference (gigl_tpu.losses), values and gradients.

retrieval_loss runs K5's plain twins here (CPU tensors); its gradient is
K5's backward formula, held against jax.value_and_grad. fp32: loss_sum
within 1e-5 relative and d/dscores within 1e-5 of the gradient's scale
(same math, sums in another order). bf16: the reference computes the
masked logits, the logsumexp and the gradient in bf16, the port in fp32
with one rounding of dS, so they agree to a few bf16 ulps: loss within 2e-2
relative, dS within 2e-2 of its scale (2**-7 is one bf16 ulp relative).
Ranks are integers and must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.losses import losses as ref
from gigl_tpu.losses import metrics as ref_metrics
from gigl_tpu_torch.losses import losses as port
from gigl_tpu_torch.losses import metrics as port_metrics
from gigl_tpu_torch.ops import retrieval as k5

torch.set_num_threads(1)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _retrieval_case(name, seed=0):
    """(scores [Q, C], kwargs of numpy arrays) for one masking case."""
    rng = np.random.default_rng(seed)
    q, c = {"q_gt_c": (20, 12)}.get(name, (16, 48))
    scores = (rng.normal(size=(q, c)) * 0.5).astype(np.float32)
    kw = {"temperature": None if name == "q_gt_c" else 0.07}
    if name in ("dup_queries", "all"):
        kw["query_ids"] = rng.integers(0, 6, q).astype(np.int32)
    if name in ("accidental_hits", "all"):
        kw["candidate_ids"] = rng.integers(0, 10, c).astype(np.int32)
        kw["remove_accidental_hits"] = True
    if name in ("masked", "all"):
        cmask = rng.random(c) < 0.75
        qmask = rng.random(q) < 0.8
        qmask[:q] &= cmask[:q]  # a row whose positive is padded is masked
        kw["candidate_mask"], kw["query_mask"] = cmask, qmask
    return scores, kw


CASES = ["plain", "dup_queries", "accidental_hits", "masked", "all", "q_gt_c"]


def _jax_retrieval(scores, kw, dtype):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}

    def f(s):
        loss, count = ref.retrieval_loss(s, **jkw)
        return loss.astype(jnp.float32), count

    (loss, count), grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(scores).astype(JAX_DTYPES[dtype]))
    return (float(loss), int(count),
            np.asarray(grad.astype(jnp.float32)))


def _port_retrieval(scores, kw, dtype):
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    s = torch.from_numpy(scores).to(TORCH_DTYPES[dtype]).requires_grad_()
    loss, count = port.retrieval_loss(s, **tkw)
    (grad,) = torch.autograd.grad(loss, s)
    assert loss.dtype == torch.float32 and count.dtype == torch.int32
    assert grad.dtype == s.dtype
    return float(loss.detach()), int(count), grad.float().numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retrieval_loss_and_grad_match(case, dtype):
    scores, kw = _retrieval_case(case)
    want_loss, want_count, want_grad = _jax_retrieval(scores, kw, dtype)
    got_loss, got_count, got_grad = _port_retrieval(scores, kw, dtype)
    assert got_count == want_count
    assert np.isfinite(got_loss) and np.isfinite(got_grad).all()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert abs(got_loss - want_loss) <= tol * abs(want_loss)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0,
                               atol=tol * np.abs(want_grad).max())


def test_retrieval_masks_are_applied():
    """Masked queries contribute nothing; masked candidates get no
    gradient; the fixed-order forward is deterministic."""
    scores, kw = _retrieval_case("all")
    _, count, grad = _port_retrieval(scores, kw, "float32")
    assert count == int(kw["query_mask"].sum())
    np.testing.assert_array_equal(grad[~kw["query_mask"]], 0.0)
    np.testing.assert_array_equal(grad[:, ~kw["candidate_mask"]], 0.0)
    masks = k5.RetrievalMasks(
        temperature=0.07,
        query_ids=torch.from_numpy(kw["query_ids"]),
        candidate_ids=torch.from_numpy(kw["candidate_ids"]),
        remove_accidental_hits=True,
        query_mask=torch.from_numpy(kw["query_mask"]),
        candidate_mask=torch.from_numpy(kw["candidate_mask"]))
    s = torch.from_numpy(scores)
    a, b = k5.retrieval_fwd(s, masks), k5.retrieval_fwd(s, masks)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    np.testing.assert_array_equal(a[3].numpy()[~kw["query_mask"]], 0.0)


def test_retrieval_loss_unported_and_invalid_options_raise():
    s = torch.zeros((4, 8))
    # the logQ correction is ported (tests/test_torch_cms.py); a probability
    # vector of the wrong length raises
    with pytest.raises(ValueError, match="candidate_sampling_probability"):
        port.retrieval_loss(s, candidate_sampling_probability=torch.ones(4))
    with pytest.raises(ValueError, match="candidate_ids"):
        port.retrieval_loss(s, remove_accidental_hits=True)


def _pair_inputs(seed=1, q=12, p=3, n=20):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(q, p)).astype(np.float32)
    neg = rng.normal(size=(q, n)).astype(np.float32)
    pos_mask = rng.random((q, p)) < 0.7
    neg_mask = rng.random((q, n)) < 0.8
    return pos, neg, pos_mask, neg_mask


@pytest.mark.parametrize("loss", ["margin", "softmax"])
@pytest.mark.parametrize("masked", [False, True])
def test_pair_losses_and_grads_match(loss, masked):
    pos, neg, pm, nm = _pair_inputs()
    kw = {"margin": 0.5} if loss == "margin" else {"temperature": 0.3}
    masks = {"pos_mask": pm, "neg_mask": nm} if masked else {}

    def jf(a, b):
        s, c = getattr(ref, f"{loss}_loss")(
            a, b, **kw, **{k: jnp.asarray(v) for k, v in masks.items()})
        return s, c

    (want, wcount), (wga, wgb) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(pos), jnp.asarray(neg))
    tp = torch.from_numpy(pos).requires_grad_()
    tn = torch.from_numpy(neg).requires_grad_()
    got, gcount = getattr(port, f"{loss}_loss")(
        tp, tn, **kw, **{k: torch.from_numpy(v) for k, v in masks.items()})
    ga, gb = torch.autograd.grad(got, (tp, tn))
    assert int(gcount) == int(wcount)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wga), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wgb), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shared_negs", [False, True])
def test_ranking_metrics_match(shared_negs):
    rng = np.random.default_rng(2)
    # Scores on a coarse grid so ties with the positive are common.
    pos = rng.integers(0, 5, 30).astype(np.float32)
    neg = rng.integers(0, 5, (20,) if shared_negs else (30, 20)).astype(
        np.float32)
    pos_mask = rng.random(30) < 0.8
    neg_mask = rng.random(neg.shape) < 0.7
    ks = (1, 3, 10)
    jargs = (jnp.asarray(pos), jnp.asarray(neg))
    targs = (torch.from_numpy(pos), torch.from_numpy(neg))
    np.testing.assert_array_equal(
        port_metrics._ranks(*targs, torch.from_numpy(neg_mask)).numpy(),
        np.asarray(ref_metrics._ranks(*jargs, jnp.asarray(neg_mask))))
    whits, wcnt = ref_metrics.hits_at_k(*jargs, ks,
                                        pos_mask=jnp.asarray(pos_mask),
                                        neg_mask=jnp.asarray(neg_mask))
    ghits, gcnt = port_metrics.hits_at_k(*targs, ks,
                                         pos_mask=torch.from_numpy(pos_mask),
                                         neg_mask=torch.from_numpy(neg_mask))
    assert int(gcnt) == int(wcnt)
    assert {k: int(v) for k, v in ghits.items()} == {
        k: int(v) for k, v in whits.items()}
    wrr, wc = ref_metrics.mean_reciprocal_rank(
        *jargs, pos_mask=jnp.asarray(pos_mask))
    grr, gc = port_metrics.mean_reciprocal_rank(
        *targs, pos_mask=torch.from_numpy(pos_mask))
    assert int(gc) == int(wc)
    np.testing.assert_allclose(float(grr), float(wrr), rtol=1e-6)
