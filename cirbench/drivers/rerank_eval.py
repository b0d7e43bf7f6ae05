"""Stage-II re-rank evaluation: ``retrieval/validate2_engine.
evaluate_cirr_stage2_datasets`` over an in-memory CIRR-shaped split.

One call is one whole evaluation: the stage-II ViT bank of the corpus,
z_t of every query (stage-I fusion over the bank's reference rows), and
the candidate-major scoring of every query's top-K and group pairs.

The comparison, on a sample of queries drawn from the seed (the longest
caption in it): the bank rows of their images, as the re-ranker's ViT
produced them in the last call, and the top-K and group logits and orders
of every call, against the plain reference; z_t is covered through the
logits, since the engine returns it to no caller."""
from __future__ import annotations

import numpy as np
import torch

from cirbench import compare, system
from cirbench.counts import blip as counts
from cirbench.reference import blip as ref
from cirbench.reference import text as ref_text
from cirbench.traffic import cirr


class Cell:
    kernels_per_launch = 1

    def __init__(self, cfg: dict, traffic: dict, engine: dict, seed: int,
                 device: str):
        self.cfg, self.traffic, self.engine = cfg, traffic, engine
        self.seed, self.device = seed, device
        self.sample_size = engine.get("check_queries", 32)

    def setup(self, warm: bool = True) -> None:
        from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine \
            import evaluate_cirr_stage2_datasets

        self.evaluate = evaluate_cirr_stage2_datasets
        cfg, dev = self.cfg, self.device
        self.s1, self.w1 = system.build_stage1(cfg, self.seed, dev)
        self.s2, self.w2 = system.build_reranker(cfg, self.seed, dev)
        self.tok = system.tokenizer()
        self.vocab = cirr.load_vocab()
        images = cirr.make_images(self.traffic["images"],
                                  cfg["vit"]["image_size"], self.seed, dev)
        self.corpus = cirr.Corpus(images)
        self.queries = cirr.make_queries(
            self.traffic, self.corpus.index_names, self.seed,
            cirr.caption_words(self.vocab))
        self.rows = self.queries.rows()
        self.bank = system.Capture(self.s2.visual_encoder)
        if warm:
            self.call()                  # every shape of a call

    def call(self) -> dict:
        e = self.engine
        self.bank.clear()
        res = self.evaluate(
            self.s1, None, self.s2, None, self.tok, self.corpus, self.rows,
            k=e["k"], text_len=self.cfg["text_len"],
            batch_size=e["batch_size"], l_buckets=e["l_buckets"],
            schedule=e["schedule"], device=self.device)
        out = res.rerank
        return {"queries": len(self.rows), "seconds": dict(res.seconds),
                "logits": out.logits, "group_logits": out.group_logits,
                "order": out.order, "group_order": out.group_order}

    def outputs(self, rec: dict) -> dict:
        return {k: rec[k] for k in ("logits", "group_logits", "order",
                                    "group_order")}

    def work(self) -> dict:
        """One call's counts, and the call's units of work."""
        q = self.queries
        hit = q.topk_hit()
        k = self.engine["k"]
        lengths = q.lengths
        pair_lengths = np.concatenate([
            np.repeat(lengths[hit], k),
            np.repeat(lengths, q.group.shape[1] - 1)])
        cands = np.union1d(np.unique(q.topk[hit]), np.unique(q.group[:, 1:]))
        c = counts.rerank_eval_call(
            self.cfg, len(self.corpus), lengths, len(np.unique(q.ref)),
            pair_lengths, len(cands))
        return {**c.as_dict(), "images": len(self.corpus),
                "queries": len(lengths), "pairs": len(pair_lengths)}

    def release(self) -> None:
        """Frees the program's models; keeps the sampled bank rows."""
        sample = self.sample()
        need = self.images_of(sample)
        chunks = self.bank.outputs
        bs = self.engine["batch_size"]
        self.bank_rows = {int(i): chunks[i // bs][i % bs].float().cpu()
                          for i in need}
        self.bank.close()
        self.bank = None
        del self.s1, self.s2, chunks

    # -- the comparison ----------------------------------------------------
    def sample(self) -> np.ndarray:
        q = self.queries
        hit = np.flatnonzero(q.topk_hit())
        longest = hit[np.argmax(q.lengths[hit])]
        rows = cirr.sample_rows(len(hit), self.sample_size, self.seed,
                                must=np.flatnonzero(hit == longest))
        return hit[rows]

    def images_of(self, sample) -> np.ndarray:
        q = self.queries
        return np.unique(np.concatenate(
            [q.ref[sample], q.topk[sample].ravel(),
             q.group[sample, 1:].ravel()]))

    @torch.no_grad()
    def reference(self, sample, num: ref.Numerics) -> dict:
        """The reference's bank rows, logits and group logits of the
        sampled queries, computed with ``num``."""
        ref.tf32_off()
        cfg, q, dev = self.cfg, self.queries, self.device
        need = self.images_of(sample)
        feats = {}
        for start in range(0, len(need), 8):
            idx = need[start:start + 8]
            imgs = torch.from_numpy(self.corpus.images[idx]).to(dev)
            out = ref.vit_forward(self.w2, cfg["vit"], imgs, num)
            for i, f in zip(idx, out):
                feats[int(i)] = f
        logits, glogits = [], []
        for qi in sample:
            ids, mask = (torch.from_numpy(a).to(dev) for a in
                         ref_text.encode(q.words[qi], self.vocab))
            _, z_t = ref.fused_query(self.w1, cfg, ids, mask,
                                     feats[int(q.ref[qi])][None], num)
            cands = np.concatenate([q.topk[qi], q.group[qi, 1:]])
            scores = ref.rerank_scores(
                self.w2, cfg["text"], ids, mask, z_t,
                torch.stack([feats[int(c)] for c in cands]), num).cpu()
            k = q.topk.shape[1]
            logits.append(scores[:k].numpy())
            glogits.append(scores[k:].numpy())
        return {"bank": {i: f.cpu() for i, f in feats.items()},
                "logits": np.stack(logits), "group_logits": np.stack(glogits)}

    def program_sample(self, sample, outputs: list[dict]) -> list[dict]:
        """The program's answers for the sample, one dict a call."""
        return [{"bank": self.bank_rows if i == len(outputs) - 1 else None,
                 "logits": o["logits"][sample],
                 "group_logits": o["group_logits"][sample],
                 "order": o["order"][sample],
                 "group_order": o["group_order"][sample]}
                for i, o in enumerate(outputs)]

    @staticmethod
    def as_program(r: dict) -> dict:
        """A reference result in the program's place (the control)."""
        return {"bank": r["bank"], "logits": r["logits"],
                "group_logits": r["group_logits"],
                "order": np.argsort(-r["logits"], axis=1, kind="stable"),
                "group_order": np.argsort(-r["group_logits"], axis=1,
                                          kind="stable")}

    @staticmethod
    def numbers(got: list[dict], want: dict) -> dict:
        spread = float(np.concatenate([want["logits"].ravel(),
                                       want["group_logits"].ravel()]).std())
        bank = logit = gap = 0.0
        for g in got:
            if g["bank"] is not None:
                keys = sorted(g["bank"])
                bank = max(bank, compare.rel_err(
                    torch.stack([g["bank"][i] for i in keys]).numpy(),
                    torch.stack([want["bank"][i] for i in keys]).numpy()))
            logit = max(logit,
                        compare.value_err(g["logits"], want["logits"],
                                          spread),
                        compare.value_err(g["group_logits"],
                                          want["group_logits"], spread))
            for q in range(len(want["logits"])):
                gap = max(gap,
                          compare.order_gap(g["order"][q],
                                            want["logits"][q], spread),
                          compare.order_gap(g["group_order"][q],
                                            want["group_logits"][q], spread))
        return {"bank_rel_err": bank, "logit_err": logit, "rank_gap": gap}

    def check(self, outputs: list[dict]) -> dict:
        sample = self.sample()
        want = self.reference(sample, ref.FP32)
        return self.numbers(self.program_sample(sample, outputs), want)

    def control(self, lowp: str = "fp8") -> dict:
        """The reference at ``lowp`` in the program's place."""
        sample = self.sample()
        want = self.reference(sample, ref.FP32)
        low = self.reference(sample, ref.Numerics(lowp))
        return self.numbers([self.as_program(low)], want)
