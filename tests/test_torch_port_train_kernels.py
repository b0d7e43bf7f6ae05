"""Train kernels K5-K7 of the port and the K1-K4 backward, on the CPU.

The port's plain versions (what its wrappers run on CPU tensors) against
the Pallas kernels they replace, run by the Pallas interpreter, and the
port's optimizer against optax. Tolerances follow
tests/test_pallas_attention*.py: fp32 atol 2e-5 forward and 3e-5
gradients, bf16 atol 2e-2; the K5 mask is bit-exact; the optimizer atol
1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_utils import f32, t
from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu.ops import attention as jattn
from candidate_reranking_cir_tpu.ops import pallas_attention as jpa
from candidate_reranking_cir_tpu.ops import pallas_attention_train as jpat
from candidate_reranking_cir_tpu.parallel.contrastive import (
    cross_entropy_rows as j_cross_entropy_rows,
)
from candidate_reranking_cir_tpu.runtime import optim as joptim
from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.ops import attention as tattn
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
from candidate_reranking_cir_tpu_torch.ops import registry
from candidate_reranking_cir_tpu_torch.parallel.contrastive import (
    cross_entropy_rows,
)
from candidate_reranking_cir_tpu_torch.runtime import optim as toptim

D = 64
FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 3e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SEED = 12345


def _inputs(seed, e, lq, m, h, with_bias, dtype="float32"):
    """numpy q, k, v, g and an [E, 1, Lq, M] key-mask bias (or None), and
    the same as JAX arrays and CPU tensors in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(scale=0.5, size=s).astype(np.float32)
              for s in ((e, lq, h, D), (e, m, h, D), (e, m, h, D),
                        (e, lq, h, D))]
    bias = None
    if with_bias:
        lens = rng.integers(1, m + 1, size=e)
        mask = (np.arange(m)[None] < lens[:, None]).astype(np.int32)
        bias = np.broadcast_to(
            np.asarray(jattn.make_additive_mask(jnp.asarray(mask))),
            (e, 1, lq, m)).copy()
    jd, td = DTYPES[dtype]
    jx = [jnp.asarray(a, jd) for a in arrays]
    tx = [t(a, td) for a in arrays]
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else t(bias)
    return jx, tx, jb, tb


# ---------------------------------------------------------------------------
# (a) K5


@pytest.mark.parametrize("seed,b,h,rows,cols,rate", [
    (12345, 0, 0, 9, 21, 0.1),
    (-2 ** 31, 3, 1, 7, 13, 0.1),          # seed at the int32 minimum
    (2 ** 31 - 1, 2, 3, 5, 17, 0.5),       # ... and maximum
    (987, 9_000_000, 2, 4, 11, 0.25),      # b * 0x101 past 2^31
    (-77, 8_400_000, 11, 6, 577, 0.1),     # 577 keys, as on the path
])
def test_keep_mask_bit_exact(seed, b, h, rows, cols, rate):
    ref = np.asarray(jpat.reference_keep_mask(seed, b, h, (rows, cols), rate))
    out = tat.keep_mask(seed, b, h, rows, cols, rate)
    np.testing.assert_array_equal(out.numpy(), ref)
    written = tat.write_keep_mask(torch.empty(rows, cols, dtype=torch.uint8),
                                  seed, b, h, rate)
    np.testing.assert_array_equal(written.numpy(), ref.astype(np.uint8))


def test_keep_mask_broadcasts_entries_and_heads():
    e, h, rows, cols = 3, 2, 5, 7
    out = tat.keep_mask(SEED, torch.arange(e).view(e, 1),
                        torch.arange(h).view(1, h), rows, cols, 0.3)
    assert out.shape == (e, h, rows, cols)
    for bi in range(e):
        for hi in range(h):
            ref = jpat.reference_keep_mask(SEED, bi, hi, (rows, cols), 0.3)
            np.testing.assert_array_equal(out[bi, hi].numpy(),
                                          np.asarray(ref))


# ---------------------------------------------------------------------------
# (b), (c) K6 / K7 plain versions against the interpreted Pallas kernels

SHAPE = (2, 9, 21, 2)          # e, lq, m, h
BLOCKED = (4, 32, 33, 2)       # JAX entry-blocks it (4 entries per program)


def test_blocked_shape_is_entry_blocked_in_jax():
    e, lq, _, _ = BLOCKED
    assert jpat._pick_entries(e, lq, jpat.MAX_ENTRIES_FWD) == 4
    assert jpat._pick_entries(e, lq) == 4


@pytest.mark.parametrize("dtype,rate,with_bias,shape", [
    *[(d, r, b, SHAPE) for d in ("float32", "bfloat16")
      for r in (0.0, 0.1) for b in (False, True)],
    ("float32", 0.1, True, BLOCKED),
    ("bfloat16", 0.1, False, BLOCKED),
])
def test_k6_plain_forward_matches_pallas(dtype, rate, with_bias, shape):
    (jq, jk, jv, _), (tq, tk, tv, _), jb, tb = _inputs(1, *shape, with_bias,
                                                        dtype)
    seed = jnp.array([SEED], jnp.int32)
    ref = jpat._fwd_impl(jq, jk, jv, jb, seed, rate, interpret=True)
    e, lq, m, _ = shape
    out = tat.attention_train_plain(tq, tk, tv, tat._train_bias3(tb, e, lq, m),
                                    SEED, rate)
    assert out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(f32(out), f32(ref), atol=FWD_TOL[dtype])


@pytest.mark.parametrize("rate,with_bias,shape", [
    (0.0, False, SHAPE), (0.1, False, SHAPE), (0.0, True, SHAPE),
    (0.1, True, SHAPE), (0.1, True, BLOCKED),
])
def test_k7_plain_backward_matches_pallas(rate, with_bias, shape):
    (jq, jk, jv, jg), (tq, tk, tv, tg), jb, tb = _inputs(2, *shape,
                                                         with_bias)
    seed = jnp.array([SEED], jnp.int32)
    refs = jpat._bwd_impl(jq, jk, jv, jb, seed, jg, rate, interpret=True)
    e, lq, m, _ = shape
    outs = tat.attention_train_bwd_plain(
        tq, tk, tv, tat._train_bias3(tb, e, lq, m), SEED, tg, rate)
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(f32(out), f32(ref), atol=GRAD_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_train_attention_gradcheck_float64(with_bias):
    """The explicit backward is the gradient of the forward (rate 0.1,
    float64 on the plain path; the mask is fixed by the seed)."""
    e, lq, m, h, d = 2, 3, 5, 2, 4
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(e, n, h, d, generator=g, dtype=torch.float64,
                           requires_grad=True) for n in (lq, m, m))
    bias = None
    if with_bias:
        bias = torch.zeros(e, 1, 1, m, dtype=torch.float32)
        bias[0, ..., -2:] = -10000.0

    def fn(q, k, v):
        return tat.fused_attention_train(q, k, v, bias, -7, 0.1)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (e) the train routes against JAX's (thresholds at 0, as in
# tests/test_pallas_attention_train.py; the port's copies likewise)


@pytest.fixture
def no_thresholds(monkeypatch):
    for mod in (jpat, tat):
        monkeypatch.setattr(mod, "MIN_KV", 0)
        monkeypatch.setattr(mod, "MIN_ROWS", 0)


def _vjp_both(jfn, tfn, jx, tx, cot):
    jout, vjp = jax.vjp(jfn, *jx)
    jgrads = vjp(jnp.asarray(cot))
    tx = [x.clone().requires_grad_() for x in tx]
    tout = tfn(*tx)
    tgrads = torch.autograd.grad(tout, tx, t(cot))
    return (jout, jgrads), (tout, tgrads)


def _assert_route(j, tr):
    (jout, jgrads), (tout, tgrads) = j, tr
    np.testing.assert_allclose(f32(tout), f32(jout), atol=2e-5)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(f32(a), f32(b), atol=GRAD_TOL)


def test_pair_cross_attention_train_route(no_thresholds):
    n_q, n_c, lq, m, h = 3, 4, 5, 21, 2
    rng = np.random.default_rng(3)
    q = rng.normal(scale=0.5, size=(n_q, n_c, lq, h, D)).astype(np.float32)
    k, v = (rng.normal(scale=0.5, size=(n_c, m, h, D)).astype(np.float32)
            for _ in range(2))
    cot = rng.normal(size=q.shape).astype(np.float32)
    key = jax.random.key(3)
    seed = int(jpat.seed_from_rng(key)[0])
    j, tr = _vjp_both(
        lambda q, k, v: jattn.pair_cross_attention(
            q, k, v, None, dropout_rate=0.1, dropout_rng=key,
            deterministic=False, fused=True),
        lambda q, k, v: tattn.pair_cross_attention(
            q, k, v, dropout_rate=0.1, deterministic=False, seed=seed),
        [jnp.asarray(x) for x in (q, k, v)], [t(x) for x in (q, k, v)], cot)
    _assert_route(j, tr)


def test_dot_product_attention_train_route_with_bias(no_thresholds):
    """Unfolded train route with a [B, 1, 1, 1, L] key mask over a 2-D
    batch (JAX ``_try_fused_train``)."""
    a, b, lq, h = 2, 3, 7, 2
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(scale=0.5, size=(a, b, lq, h, D)).astype(
        np.float32) for _ in range(3))
    mask = np.ones((a, b, lq), np.int32)
    mask[0, 1, 4:] = 0
    cot = rng.normal(size=q.shape).astype(np.float32)
    jbias = jattn.make_additive_mask(jnp.asarray(mask))
    tbias = tattn.make_additive_mask(t(mask))
    key = jax.random.key(4)
    seed = int(jpat.seed_from_rng(key)[0])
    j, tr = _vjp_both(
        lambda q, k, v: jattn.dot_product_attention(
            q, k, v, jbias, dropout_rate=0.1, dropout_rng=key,
            deterministic=False, fused=True),
        lambda q, k, v: tattn.dot_product_attention(
            q, k, v, tbias, dropout_rate=0.1, deterministic=False,
            seed=seed),
        [jnp.asarray(x) for x in (q, k, v)], [t(x) for x in (q, k, v)], cot)
    _assert_route(j, tr)


def test_folded_train_route_matches_jax_on_cpu():
    """The folded train route (K8 on the card) runs the unfolded plain
    versions on the CPU; the mask is the same function of the absolute
    entry index."""
    a, b, lq, h = 2, 2, 6, 2
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(scale=0.5, size=(a, b, lq, h * D)).astype(
        np.float32) for _ in range(3))
    mask = np.ones((a, b, lq), np.int32)
    mask[1, 0, 3:] = 0
    cot = rng.normal(size=q.shape).astype(np.float32)
    jbias = jattn.make_additive_mask(jnp.asarray(mask))
    tbias = tattn.make_additive_mask(t(mask))
    key = jax.random.key(5)
    seed = int(jpat.seed_from_rng(key)[0])
    j, tr = _vjp_both(
        lambda q, k, v: jattn.dot_product_attention_folded_train(
            q, k, v, jbias, num_heads=h, dropout_rng=key, dropout_rate=0.1),
        lambda q, k, v: tattn.dot_product_attention_folded_train(
            q, k, v, tbias, num_heads=h, seed=seed, dropout_rate=0.1),
        [jnp.asarray(x) for x in (q, k, v)], [t(x) for x in (q, k, v)], cot)
    _assert_route(j, tr)


# ---------------------------------------------------------------------------
# (f) the K1-K4 backward: kernel forward, plain-recompute backward


@pytest.mark.parametrize("kid", ["K1", "K2", "K3", "K4"])
def test_eval_kernel_backward_matches_jax_vjp(kid, monkeypatch):
    """``registry.PlainBackward`` with the eval kernel replaced by the plain
    version (the card's forward cannot run here), so that its backward runs
    on the CPU; against jax.vjp of the Pallas kernel's custom_vjp
    (interpreted)."""
    monkeypatch.setattr(
        ck, "_kernel_forward",
        lambda kid, q, k, v, b: ck.attention_plain(q, k, v, b))
    folded = kid in ("K1", "K4")
    with_bias = kid in ("K2", "K4")
    e, lq, m, h = 2, 7, 13, 2
    (jq, jk, jv, jg), (tq, tk, tv, tg), jb, tb = _inputs(6, e, lq, m, h,
                                                         with_bias)
    if folded:
        jq, jk, jv, jg = (x.reshape(*x.shape[:2], h * D)
                          for x in (jq, jk, jv, jg))
        tq, tk, tv, tg = (x.flatten(-2) for x in (tq, tk, tv, tg))
        jfn = lambda q, k, v: jpa.fused_attention_folded(q, k, v, jb,
                                                         num_heads=h)
    else:
        jfn = lambda q, k, v: jpa.fused_attention(q, k, v, jb)
    _, vjp = jax.vjp(jfn, jq, jk, jv)
    refs = vjp(jg)

    tx = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    q4, k4, v4 = ((x.unflatten(-1, (h, D)) if folded else x) for x in tx)
    out = registry.PlainBackward.apply(
        ck._kernel_forward, ck._plain_forward, kid, q4, k4, v4,
        None if tb is None else ck._bias3(tb, e, lq, m))
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.flatten(-2) if folded else out, tx, tg)
    for a, b in zip(grads, refs):
        np.testing.assert_allclose(f32(a), f32(b), atol=GRAD_TOL)
    # the CPU wrapper (plain version under autograd) gives the same
    wrap = ck.fused_attention_folded(*tx, tb, num_heads=h) if folded \
        else ck.fused_attention(*tx, tb)
    for a, b in zip(torch.autograd.grad(wrap, tx, tg), grads):
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-6)


# ---------------------------------------------------------------------------
# (g) optimizer, schedules and the loss against optax / JAX


@pytest.mark.parametrize("name,args", [
    ("cosine_epoch_schedule", (1e-3, 1e-5, 10, 4)),
    ("warmup_schedule", (1e-6, 1e-3, 7)),
    ("step_epoch_schedule", (1e-3, 1e-5, 0.5, 3)),
    ("exp_epoch_schedule", (1e-3, 0.9, 5)),
])
def test_schedules_match_jax(name, args):
    jfn, tfn = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for step in range(0, 60, 3):
        # JAX evaluates the schedules in float32
        np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6,
                                   atol=1e-9)


def _param_values(rng):
    """Initial values at the models' scale (normal, std 0.05), where one
    float32 rounding step is well below the 1e-7 tolerance."""
    return {"visual_encoder": {"w": rng.normal(scale=0.05, size=(3, 4))},
            "text": {"w": rng.normal(scale=0.05, size=(5,)),
                     "b": rng.normal(scale=0.05, size=(2, 2))}}


class _Params(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for group, leaves in values.items():
            mod = torch.nn.Module()
            for name, val in leaves.items():
                setattr(mod, name, torch.nn.Parameter(
                    torch.tensor(val, dtype=torch.float32)))
            setattr(self, group, mod)


def _run_both(accumulation: int, micro_steps: int):
    """The same gradients (zero for the frozen ViT, as the step gives it)
    into optax's make_optimizer and the port's; yields both parameter sets
    after each micro-step."""
    rng = np.random.default_rng(7)
    values = _param_values(rng)
    cfg_kw = dict(learning_rate=1e-2, min_lr=1e-4, weight_decay=0.05,
                  cosine_max_epoch=3, grad_accumulation=accumulation)
    jparams = {"params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), values)}
    tx, _ = joptim.make_optimizer(jcfg.TrainConfig(**cfg_kw), jparams, 2,
                                  freeze_prefixes=("params/visual_encoder",))
    jstate = tx.init(jparams)
    model = _Params(values)
    opt, _ = toptim.make_optimizer(tcfg.TrainConfig(**cfg_kw), model, 2,
                                   freeze_prefixes=("visual_encoder",))
    for _ in range(micro_steps):
        grads = {"visual_encoder": {"w": np.zeros((3, 4))},
                 "text": {k: rng.normal(size=v.shape)
                          for k, v in values["text"].items()}}
        jgrads = {"params": jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32), grads)}
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for name, val in grads["text"].items():
            getattr(model.text, name).grad = torch.tensor(val,
                                                          dtype=torch.float32)
        opt.step()
        yield jparams["params"], model


@pytest.mark.parametrize("accumulation,micro_steps", [(1, 3), (2, 6)])
def test_adamw_freezing_and_accumulation_match_optax(accumulation,
                                                     micro_steps):
    frozen0 = None
    for jp, model in _run_both(accumulation, micro_steps):
        for name in ("w", "b"):
            np.testing.assert_allclose(
                getattr(model.text, name).detach().numpy(),
                np.asarray(jp["text"][name]), atol=1e-7, rtol=0)
        w = model.visual_encoder.w.detach().numpy().copy()
        frozen0 = w if frozen0 is None else frozen0
        np.testing.assert_array_equal(w, frozen0)
        np.testing.assert_array_equal(w, np.asarray(jp["visual_encoder"]["w"]))
        assert not model.visual_encoder.w.requires_grad


def test_cross_entropy_rows_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(scale=3.0, size=(5, 5)).astype(np.float32)
    labels = np.arange(5)
    ref = j_cross_entropy_rows(jnp.asarray(logits, jnp.bfloat16),
                               jnp.asarray(labels))
    out = cross_entropy_rows(t(logits, torch.bfloat16), torch.arange(5))
    np.testing.assert_allclose(float(out), float(ref), atol=1e-6)
