"""Stage-II re-rank evaluation with Kimi-VL-A3B-Instruct as a point-wise
re-ranker: ``retrieval/validate2_engine.evaluate_cirr_stage2_datasets``
with ``stage1=None``, the port's ``KimiVLReranker`` and
``schedule='query_major'`` over an in-memory CIRR-shaped split.

One call is one whole evaluation: the bank of the corpus (MoonViT and the
projector, the layer span 'index'), then chunks of ``q_batch`` queries,
each a prefix pass over the queries' reference tokens and captions
('prefix') and a suffix pass over their top-K and group candidates that
attends to the prefixes' kept latents ('score'). Each call's routing
counters (``registry.MOE``) and latent-attention calls
(``registry.SDPA``) ride in its record.

The comparison, on one chunk of ``q_batch`` queries (the one with the
longest caption): the bank rows of their images as the projector produced
them in the last call (``bank_rel_err``), and every call's top-K and group
scores (``score_err``, the widest gap over the reference scores' spread)
and orders (``rank_gap``), against the plain reference
``cirbench/reference/kimi_vl``, which runs each (query, candidate)
sequence whole, with no cache, in float32.

Expert choices: where a token's sixth and seventh selection scores lie
closer than bfloat16's rounding, the program and the float32 reference
choose different experts, and with random weights one changed expert on a
scored token moves its score by about the scores' spread; compared on
choices of their own, the two read about 2x the spread apart after 27
layers. So after the window the program's chunk is run once more as the
engine ran it (``rerank_prefixed``, the same shapes: the same numbers),
its routers' choices kept. The reference takes a token's choice from the
program only where it is a near tie on the reference's own path: each
expert that the reference would not choose scores within ``ROUTE_MARGIN``
under the reference's own sixth (``reference.Routes``). Elsewhere the
reference keeps its own choice, and ``route_flip`` reads the share of the
program's choices that lie beyond the margin. The control (the reference
one precision lower in the program's place) is held the same way: its own
choices go to the float32 reference under the same margin."""
from __future__ import annotations

import sys

import numpy as np
import torch

from cirbench import system
from cirbench.counts import kimi_vl as counts
from cirbench.drivers import rerank_eval
from cirbench.reference import kimi_vl as ref
from cirbench.traffic import cirr


# A forced expert choice is a near tie when the reference's own selection
# score of that expert lies within this of its own sixth: four steps of
# bfloat16 at the scores' scale (the sigmoid's [0.5, 1), where bfloat16's
# step is 2^-8), the drift of 27 bfloat16 layers included (PERF.md §2)
ROUTE_MARGIN = 2.0 ** -6


def port_config(cfg: dict):
    from candidate_reranking_cir_tpu_torch.config import (
        KimiLMConfig,
        KimiVLRerankerConfig,
        MoonViTConfig,
        RerankTemplate,
    )

    lm_keys = KimiLMConfig.__dataclass_fields__
    t = cfg["template"]
    return KimiVLRerankerConfig(
        vision=MoonViTConfig(**cfg["vision"]),
        lm=KimiLMConfig(**{k: cfg[k] for k in lm_keys if k in cfg}),
        template=RerankTemplate(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in t.items()}))


class Cell(rerank_eval.Cell):
    kernels_per_launch = 1

    def setup(self, warm: bool = True) -> None:
        # first, so that a program without Kimi-VL fails at once
        from candidate_reranking_cir_tpu_torch.models.kimi_vl import (
            KimiVLReranker,
        )
        from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine \
            import evaluate_cirr_stage2_datasets

        self.evaluate = evaluate_cirr_stage2_datasets
        cfg, dev = self.cfg, self.device
        self.wseed = cirr.stream_seed(self.seed, "weights_reranker")
        self.model = KimiVLReranker(port_config(cfg),
                                    dtype=system.DTYPES[cfg["dtype"]],
                                    device=dev).eval()
        ref.load_into(self.model.named_parameters(), cfg, self.wseed)
        self.tok = system.tokenizer()
        self.vocab = cirr.load_vocab()
        images = cirr.make_images(self.traffic["images"],
                                  cfg["vision"]["image_size"], self.seed, dev)
        self.corpus = cirr.Corpus(images)
        self.queries = cirr.make_queries(
            self.traffic, self.corpus.index_names, self.seed,
            cirr.caption_words(self.vocab))
        self.rows = self.queries.rows()
        self.bank = system.Capture(self.model.projector)
        if warm:
            self.call()                  # every shape of a call

    def call(self) -> dict:
        from candidate_reranking_cir_tpu_torch.ops import registry

        e = self.engine
        self.bank.clear()
        for counters in (registry.MOE, registry.SDPA):
            counters.update(dict.fromkeys(counters, 0))
        res = self.evaluate(
            None, None, self.model, None, self.tok, self.corpus, self.rows,
            k=e["k"], text_len=self.cfg["text_len"],
            batch_size=e["batch_size"], schedule=e["schedule"],
            q_batch=e["q_batch"], device=self.device)
        out = res.rerank
        return {"queries": len(self.rows), "seconds": dict(res.seconds),
                "moe": {"routed": int(registry.MOE["routed"]),
                        "busiest": int(registry.MOE["busiest"]),
                        "experts": self.cfg["n_routed_experts"]},
                "sdpa": dict(registry.SDPA),
                "logits": out.logits, "group_logits": out.group_logits,
                "order": out.order, "group_order": out.group_order}

    def suffix_len(self) -> int:
        """A candidate's suffix: 216 tokens at the cell's size."""
        t = self.cfg["template"]
        return (len(t["media_start_ids"]) + counts.image_tokens(self.cfg)
                + len(t["media_end_ids"]) + len(t["question_ids"])
                + len(t["assistant_ids"]))

    def prefix_lengths(self) -> np.ndarray:
        t = self.cfg["template"]
        fixed = (len(t["template_ids"]) + len(t["media_start_ids"])
                 + counts.image_tokens(self.cfg) + len(t["media_end_ids"]))
        return fixed + np.asarray([len(w) for w in self.queries.words])

    def work(self) -> dict:
        """One call's counts, and the call's units of work."""
        q, cfg, e = self.queries, self.cfg, self.engine
        n_suffix = self.pairs_per_query()
        lengths = self.prefix_lengths()
        layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
        passes = []
        for start in range(0, len(lengths), e["q_batch"]):
            chunk = lengths[start:start + e["q_batch"]]
            rows = len(chunk) * n_suffix
            # every routed layer's prefix and suffix pass; the last layer's
            # suffix pass routes the last rows alone
            passes += [float(chunk.sum())] * layers
            passes += [float(rows * self.suffix_len())] * (layers - 1) \
                + [rows]
        c = counts.rerank_eval_call(cfg, len(self.corpus), lengths, n_suffix,
                                    self.suffix_len(), passes)
        return {**c, "images": len(self.corpus), "queries": len(lengths),
                "pairs": len(lengths) * n_suffix}

    def release(self) -> None:
        """Runs the sampled chunk once more with its expert choices kept,
        then frees the program's model; keeps the sampled bank rows.
        Once only: a second call (the harness's, after a fault in the
        first) does nothing."""
        if self.bank is None:
            return
        sample = self.sample()
        chunks = self.bank.outputs
        bs = self.engine["batch_size"]
        rows = {int(i): chunks[i // bs][i % bs]
                for i in self.images_of(self.chunk_of(sample))}
        self.bank_rows = {int(i): rows[int(i)].float().cpu()
                          for i in self.images_of(sample)}
        self.bank.close()
        self.bank = None
        self.replay, self.routes = self.replay_chunk(sample, rows)
        del self.model, chunks, rows

    def replay_chunk(self, sample, rows: dict) -> tuple[dict, dict]:
        """The sampled queries' chunk through ``rerank_prefixed`` as the
        engine ran it (the same queries, padding and shapes), with every
        routed layer's choices kept: (the sample's scores and orders, the
        choices as ``reference.Routes.forced`` takes them, on the host)."""
        from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
            rerank_prefixed,
        )

        chunk = self.chunk_of(sample)
        keep = sorted(rows)
        names = [self.corpus.index_names[i] for i in keep]
        kept: dict = {}
        hooks = [layer.mlp.gate.register_forward_hook(
                     lambda mod, args, out, i=i:
                     kept.setdefault(i, []).append(out[0].cpu()))
                 for i, layer in enumerate(self.model.lm.layers)
                 if i >= self.cfg["first_k_dense_replace"]]
        picked = [self.rows[r] for r in chunk]
        try:
            out = rerank_prefixed(
                self.model, None, self.tok,
                captions=[r["caption"] for r in picked],
                reference_names=[r["reference_name"] for r in picked],
                topk_names=np.stack([r["topk_names"] for r in picked]),
                index_feats=torch.stack([rows[i] for i in keep]),
                index_names=names, text_len=self.cfg["text_len"],
                q_batch=self.engine["q_batch"],
                group_members=[r["group_members"] for r in picked],
                device=self.device)
        finally:
            for h in hooks:
                h.remove()
        at = np.searchsorted(chunk, sample)
        return ({"logits": out.logits[at],
                 "group_logits": out.group_logits[at],
                 "order": out.order[at], "group_order": out.group_order[at]},
                self.forced_routes(sample, at, kept))

    def forced_routes(self, sample, at, kept: dict) -> dict:
        """A routed layer's choices in the chunk's prefix pass ([q_batch x
        Lp, k]) and suffix pass ([q_batch x C x 216, k]; the last layer's
        [q_batch x C, k], its last positions'), laid out as the reference's
        sequences of the sample (its queries at rows ``at`` of the chunk):
        [Q x C, T, k], -1 where the program chose nothing (padding; the
        last layer's suffix positions but the last)."""
        lengths = self.prefix_lengths()[sample]
        qb, width = self.engine["q_batch"], self.pairs_per_query()
        ls = self.suffix_len()
        total = int(lengths.max()) + ls
        out = {}
        for i, (pre, suf) in kept.items():
            k = pre.shape[-1]
            pre, suf = pre.view(qb, -1, k), suf.view(qb, width, -1, k)
            t = torch.full((len(sample), width, total, k), -1,
                           dtype=torch.long)
            for qs, (qc, n) in enumerate(zip(at, lengths)):
                t[qs, :, :n] = pre[qc, :n]
                t[qs, :, n + ls - suf.shape[2]:n + ls] = suf[qc]
            out[i] = t.flatten(0, 1)
        return out

    def pairs_per_query(self) -> int:
        q = self.queries
        return q.topk.shape[1] + q.group.shape[1] - 1

    def chunk_of(self, sample) -> np.ndarray:
        """The rows of the engine's chunk (``q_batch`` queries in order)
        that holds the sample."""
        qb = self.engine["q_batch"]
        start = int(sample[0]) // qb * qb
        return np.arange(start, min(start + qb, len(self.rows)))

    def sample(self) -> np.ndarray:
        """The queries with a target in their top-K (the engine scores the
        others and sets them to SKIP_LOGIT) of the engine's chunk that
        holds the longest caption among such queries."""
        hit = np.flatnonzero(self.queries.topk_hit())
        first = hit[np.argmax(self.prefix_lengths()[hit])]
        chunk = self.chunk_of(np.asarray([first]))
        return np.intersect1d(chunk, hit)

    def program_sample(self, sample, outputs: list[dict]) -> list[dict]:
        """Every call's answers for the sample and the replay's."""
        return [*super().program_sample(sample, outputs),
                {"bank": None, **self.replay}]

    @torch.no_grad()
    def reference(self, sample, num: ref.Numerics,
                  routes: ref.Routes | None = None) -> dict:
        """The reference's bank rows, top-K and group scores of the sampled
        queries, computed with ``num``, its expert choices as ``routes``
        has them."""
        ref.tf32_off()
        cfg, q, dev = self.cfg, self.queries, self.device
        w = ref.Weights(cfg, self.wseed, dev)
        need = self.images_of(sample)
        toks = ref.image_tokens(
            w, cfg, torch.from_numpy(self.corpus.images[need]).to(dev), num)
        feats = dict(zip((int(i) for i in need), toks))
        cands = np.concatenate([q.topk[sample], q.group[sample, 1:]], axis=1)
        scores = ref.scores(
            w, cfg, [ref.encode(q.words[qi], self.vocab) for qi in sample],
            torch.stack([feats[int(q.ref[qi])] for qi in sample]),
            torch.stack([torch.stack([feats[int(c)] for c in row])
                         for row in cands]), num, routes).cpu().numpy()
        k = q.topk.shape[1]
        return {"bank": {i: f.cpu() for i, f in feats.items()},
                "logits": scores[:, :k], "group_logits": scores[:, k:]}

    @staticmethod
    def numbers(got: list[dict], want: dict, routes: ref.Routes) -> dict:
        out = rerank_eval.Cell.numbers(got, want)
        return {"bank_rel_err": out["bank_rel_err"],
                "score_err": out["logit_err"], "rank_gap": out["rank_gap"],
                "route_flip": routes.flip_share()}

    def check(self, outputs: list[dict]) -> dict:
        sample = self.sample()
        last = outputs[-1]
        gap = max(float(np.abs(self.replay[k] - last[k][sample]).max())
                  for k in ("logits", "group_logits"))
        print(f"[cirbench] the replayed chunk's scores against the last "
              f"call's: widest gap {gap}", file=sys.stderr, flush=True)
        routes = ref.Routes({i: t.to(self.device)
                             for i, t in self.routes.items()}, ROUTE_MARGIN)
        want = self.reference(sample, ref.FP32, routes)
        self.report(routes)
        return self.numbers(self.program_sample(sample, outputs), want,
                            routes)

    @staticmethod
    def report(routes: ref.Routes) -> None:
        print(f"[cirbench] forced expert choices {routes.summary()}",
              file=sys.stderr, flush=True)

    def control(self, lowp: str = "fp8") -> dict:
        """The reference at ``lowp`` in the program's place, its own
        expert choices forced into the float32 reference."""
        sample = self.sample()
        chose = ref.Routes()
        low = self.reference(sample, ref.Numerics(lowp), chose)
        routes = ref.Routes(chose.own, ROUTE_MARGIN)
        want = self.reference(sample, ref.FP32, routes)
        self.report(routes)
        return self.numbers([self.as_program(low)], want, routes)
