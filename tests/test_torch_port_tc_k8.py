"""The tensor-core kernel's order of work for K8 (the stage-I head-folded
dropout-attention forward), emulated on the CPU and held against the Pallas
kernel it replaces (run by the Pallas interpreter) and against the port's
plain version.

K8 runs K6's body (``attn_train_fwd_folded_tc_kernel`` in
``csrc/attention_train_tc.cuh`` over ``attn_fwd_tc_body`` in
``csrc/attention_tc.cuh``) at the folded head stride, so ``emulate_k8``
is ``emulate_k6``'s order (``tests/test_torch_port_tc_k6_k7.py``) over
[E, L, H*D] inputs, with the 64-row tile laid out as the kernel lays it
out: accumulator row 16w + 8h + i of warp w holds query row
32h + 8((w + head) % 4) + i, a warp half whose eight rows all lie past Lq
keeps no statistics and hands P.V zeros, and the mask hash takes each
row's query row. Sweep 1 keeps each row's running max and rescaled sum
over 64-key tiles; sweep 2 forms p = exp(s - max) / sum, then, at
rate > 0, kept ? p / (1 - rate) : 0, and only then rounds p to the input
type before P.V. (K8's shallower ring and its L2 hints change when tiles
arrive, not these steps.)

Tolerances follow tests/test_pallas_attention*.py: fp32 atol 2e-5, bf16
atol 2e-2.

Also here: K8's route predicate and occupancy query, how its wrapper
raises on the entry point's codes, and the profile families
``chip_smoke.py`` gives the tensor-core and fp32-FMA K8 kernels."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port_utils import f32, t
from candidate_reranking_cir_tpu.ops import pallas_attention_train as jpat
from candidate_reranking_cir_tpu_torch.ops import attention_train as tat
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D = 64
TILE = 64
SCALE = D ** -0.5
SEED = 31337


def tile_rows(rot: int) -> np.ndarray:
    """Query row (of a warpgroup's 64) that each accumulator row holds:
    the kernel's tile_row(w, h, i, rot) for row 16w + 8h + i."""
    r = np.arange(TILE)
    w, h, i = r // 16, (r // 8) % 2, r % 8
    return 32 * h + 8 * ((w + rot) % 4) + i


def live_halves(lq: int, rot: int) -> np.ndarray:
    """Each warp's halves that hold query rows, as the kernel counts them
    (the second half's first row is 32 past the first half's)."""
    first = 8 * ((np.arange(4) + rot) % 4)
    return (first < lq).astype(int) + (first + 32 < lq).astype(int)


def emulate_k8(q, k, v, seed, rate, num_heads):
    """q [E, Lq, H*D]; k, v [E, M, H*D] -> [E, Lq, H*D] in q's dtype, in
    the tensor-core K8 kernel's order and tile layout (Lq <= 64: one
    warpgroup holds every row)."""
    qh, kh, vh = (tat._heads(x, num_heads) for x in (q, k, v))
    e, lq, h, _ = qh.shape
    m = kh.shape[1]
    assert lq <= TILE
    keep = tat._keep(seed, qh, m, rate) if rate > 0.0 else None
    inv = 1.0 / (1.0 - rate)
    out = torch.zeros(e, lq, h, D)
    for head in range(h):
        rows = tile_rows(head % 4)
        halves = live_halves(lq, head % 4)
        # accumulator rows whose half keeps statistics and forms p
        active = torch.as_tensor(
            halves[np.arange(TILE) // 16] > (np.arange(TILE) // 8) % 2)
        stored = torch.as_tensor(rows < lq)
        src = torch.as_tensor(np.where(rows < lq, rows, 0))
        qt = torch.where(stored[:, None], qh[:, src, head].float(), 0.0)

        def scores(j):
            return torch.einsum("erd,emd->erm", qt,
                                kh[:, j:j + TILE, head].float()) * SCALE

        row_max = torch.full((e, TILE), -torch.inf)
        row_sum = torch.zeros(e, TILE)
        for j in range(0, m, TILE):                 # sweep 1
            s = scores(j)
            mx = torch.maximum(row_max, s.amax(-1))
            upd = row_sum * torch.exp(row_max - mx) \
                + torch.exp(s - mx[..., None]).sum(-1)
            row_sum = torch.where(active, upd, row_sum)
            row_max = torch.where(active, mx, row_max)
        acc = torch.zeros(e, TILE, D)
        for j in range(0, m, TILE):                 # sweep 2
            p = torch.exp(scores(j) - row_max[..., None]) / row_sum[..., None]
            if keep is not None:
                p = torch.where(keep[:, head][:, src, j:j + TILE], p * inv,
                                0.0)
            p = torch.where(active[:, None], p, 0.0)
            acc += torch.einsum("erm,emd->erd", p.to(v.dtype).float(),
                                vh[:, j:j + TILE, head].float())
        dst = torch.as_tensor(rows[rows < lq])
        out[:, dst, head] = acc[:, stored]
    return out.to(q.dtype).flatten(-2)


def _inputs(seed, e, lq, m, h, dtype):
    """Folded q, k, v [E, L, H*D] for JAX and for the port (same numbers)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(e, n, h * D)).astype(np.float32)
              for n in (lq, m, m)]
    jd, td = DTYPES[dtype]
    return [jnp.asarray(a, jd) for a in arrays], [t(a, td) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq", [1, 32, 40, 64])
@pytest.mark.parametrize("m", [45, 77, 130])
def test_k8_tc_order_matches_pallas(dtype, rate, lq, m):
    """One key tile (45), two (77: the second of 13 keys) and three (130);
    a tile with one row (three idle warps), 32 rows (every warp's second
    half idle), 40 (one warp with both halves, turning with the head) and
    64 (none idle); heads 0-2 take three of the four turns."""
    e, h = 2, 3
    (jq, jk, jv), (tq, tk, tv) = _inputs(lq * 1000 + m, e, lq, m, h, dtype)
    ref = jpat._fwd_impl_folded(jq, jk, jv, None,
                                jnp.array([SEED], jnp.int32), rate, h,
                                interpret=True)
    out = emulate_k8(tq, tk, tv, SEED, rate, h)
    assert out.shape == ref.shape and out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(f32(out), f32(ref), atol=TOL[dtype])
    plain = tat.attention_train_folded_plain(tq, tk, tv, None, SEED, rate,
                                             num_heads=h)
    np.testing.assert_allclose(f32(out), f32(plain), atol=TOL[dtype])


@pytest.mark.parametrize("rot", [0, 1, 2, 3])
@pytest.mark.parametrize("lq", [1, 8, 9, 32, 33, 40, 64])
def test_k8_tile_layout_skips_only_empty_halves(rot, lq):
    """The tile layout is a permutation of the 64 rows; a half that the
    kernel skips holds no row below lq; at most 32 rows leave every warp
    one half (equal shares on the four sub-partitions), 40 rows give one
    warp both halves, and which warp turns with the head."""
    rows = tile_rows(rot)
    assert sorted(rows) == list(range(TILE))
    halves = live_halves(lq, rot)
    for r, row in enumerate(rows):
        w, half = r // 16, (r // 8) % 2
        if row < lq:
            assert half < halves[w]
    if 24 < lq <= 32:
        assert list(halves) == [1, 1, 1, 1]
    if lq == 40:
        assert sorted(halves) == [1, 1, 1, 2]
        assert int(np.argmax(halves)) == (-rot) % 4
    assert halves.sum() == -(-lq // 8)


@pytest.mark.parametrize("dtype,bias,folded,tc", [
    (torch.bfloat16, None, True, True),             # K8 on the tensor cores
    (torch.bfloat16, torch.zeros(1, 4, 4), True, False),
    (torch.float32, None, True, False),
])
def test_k8_route_predicate(dtype, bias, folded, tc):
    assert tat.fwd_uses_tensor_cores(dtype, bias, folded) == tc


class _FakeTrainLibrary:
    """Stands in for the train library: K8's entry point returns ``code``
    without launching anything; the occupancy query returns ``blocks``."""

    def __init__(self, code: int = 0, blocks: int = 4):
        self.code, self.blocks = code, blocks

    def crc_attention_train_max_keys(self):
        return 1000

    def crc_attention_train_folded_forward(self, *args):
        return self.code

    def crc_attention_train_folded_forward_blocks_per_sm(self, lq, m):
        return self.blocks


@pytest.mark.parametrize("code,exc,match", [
    (ck.REFUSED_ALIGNMENT, ValueError, "aligned"),
    (700, RuntimeError, "launch failed: cudaError 700"),
])
def test_k8_wrapper_raises_on_the_entry_points_codes(monkeypatch, code, exc,
                                                     match):
    """A refused or failed K8 launch raises and counts no launch."""
    from candidate_reranking_cir_tpu_torch.ops import build

    monkeypatch.setattr(build, "load",
                        lambda name: _FakeTrainLibrary(code))
    monkeypatch.setattr(tat, "_stream", lambda device: 0)
    q, k, v = (tat._heads(torch.zeros(2, n, 2 * D, dtype=torch.bfloat16), 2)
               for n in (4, 9, 9))
    before = dict(tat.LAUNCHES)
    with pytest.raises(exc, match=f"K8.*{match}|{match}.*K8"):
        tat._kernel_fwd(q, k, v, None, 0, 0.1, folded=True)
    assert tat.LAUNCHES == before


@pytest.mark.parametrize("blocks,exc", [(4, None), (-98, RuntimeError)])
def test_k8_occupancy_query_reports_the_entry_points_answer(monkeypatch,
                                                            blocks, exc):
    from candidate_reranking_cir_tpu_torch.ops import build

    monkeypatch.setattr(build, "load",
                        lambda name: _FakeTrainLibrary(blocks=blocks))
    if exc is None:
        assert tat.folded_forward_blocks_per_sm(32, 577) == blocks
    else:
        with pytest.raises(exc, match="cudaError 98"):
            tat.folded_forward_blocks_per_sm(32, 577)


@pytest.mark.parametrize("name,family", [
    ("void crc::tc::attn_train_fwd_folded_tc_kernel<1>(__nv_bfloat16 "
     "const*, ...)", chip_smoke.TC_K8_FAMILY),
    ("void crc::tc::attn_train_fwd_folded_tc_kernel<2>(...)",
     chip_smoke.TC_K8_FAMILY),
    ("void (anonymous namespace)::attn_train_fwd_folded_kernel<float, "
     "false>(...)", chip_smoke.FMA_K8_FAMILY),
    ("void (anonymous namespace)::attn_train_fwd_folded_kernel<"
     "__nv_bfloat16, true>(...)", chip_smoke.FMA_K8_FAMILY),
    ("void crc::tc::attn_train_fwd_tc_kernel<1>(...)",
     chip_smoke.TC_K6_FAMILY),
])
def test_profile_families_name_the_k8_kernels(name, family):
    """The tensor-core K8 kernel has a family of its own, apart from K6's;
    a bf16 profile fails on time in the fp32-FMA K8 family as in the other
    FMA ones."""
    assert chip_smoke.kernel_family(name) == family
    assert (family in chip_smoke.FMA_FAMILIES) == ("FMA" in family)


def test_smoke_source_holds_the_k8_kernel():
    """The JSON line's ``source`` for K8 is the file that defines its
    tensor-core ``__global__`` entry point."""
    src = Path(chip_smoke.__file__).parent / chip_smoke.SOURCES["K8"]
    assert "\nattn_train_fwd_folded_tc_kernel(" in src.read_text()
