"""Stage-I evaluation: ``retrieval/validate_engine.evaluate_cirr_stage1``
(the multi-launch executor) over an in-memory CIRR-shaped split.

One call is one whole evaluation: the ViT index of the corpus with its
pooled features, the image-major fusion of every query, and the exact
ranking of every query against the corpus (the top-``save_topk_k`` lists
and the ranks of each query's target, reference and group members).

The comparison, against the plain reference: the pooled features of every
corpus image as the timed path produced them in the last call (the
stage-I vision projection's output, normalised), and for a sample of
queries drawn from the seed (the longest caption in it) every call's
top-K list and entity ranks; the fused predictions are covered through
them, since the engine returns them to no caller."""
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
        self.sample_size = engine.get("check_queries", 64)

    def setup(self, warm: bool = True) -> None:
        from candidate_reranking_cir_tpu_torch.retrieval.validate_engine \
            import evaluate_cirr_stage1

        self.evaluate = evaluate_cirr_stage1
        cfg, dev = self.cfg, self.device
        self.model, self.w1 = system.build_stage1(cfg, self.seed, dev)
        self.tok = system.tokenizer()
        self.vocab = cirr.load_vocab()
        images = cirr.make_images(self.traffic["images"],
                                  cfg["vit"]["image_size"], self.seed, dev)
        self.corpus = cirr.Corpus(images)
        self.queries = cirr.make_queries(
            self.traffic, self.corpus.index_names, self.seed,
            cirr.caption_words(self.vocab))
        self.rows = self.queries.rows()
        self.pooled = system.Capture(self.model.vision_proj)
        if warm:
            self.call()                  # every shape of a call

    def call(self) -> dict:
        e = self.engine
        self.pooled.clear()
        res, _ = self.evaluate(
            self.model, None, self.corpus, self.rows, self.tok,
            text_len=self.cfg["text_len"], batch_size=e["batch_size"],
            save_topk_k=e["save_topk_k"], q_batch=e["q_batch"],
            image_major=e["image_major"], device=self.device)
        return {"queries": len(self.rows), "seconds": dict(res.seconds),
                "topk": res.topk, "ranks": res.ranks,
                "index_names": res.index_names}

    def outputs(self, rec: dict) -> dict:
        if rec["index_names"] != self.corpus.index_names:
            raise AssertionError("the index is not in corpus order")
        return {"topk": rec["topk"][:, :self.engine["save_topk_k"]],
                "ranks": rec["ranks"]}

    def work(self) -> dict:
        q = self.queries
        c = counts.stage1_eval_call(self.cfg, len(self.corpus), q.lengths,
                                    len(np.unique(q.ref)), len(q.ref))
        return {**c.as_dict(), "images": len(self.corpus),
                "queries": len(q.ref)}

    def release(self) -> None:
        """Frees the program's model; keeps the pooled features."""
        proj = torch.cat([o.float() for o in self.pooled.outputs])
        self.program_pooled = ref.l2_normalize(proj).cpu().numpy()
        self.pooled.close()
        self.pooled = None
        del self.model, proj

    # -- the comparison ----------------------------------------------------
    def sample(self) -> np.ndarray:
        q = self.queries
        rows = cirr.sample_rows(len(q.ref), self.sample_size, self.seed,
                                must=[int(np.argmax(q.lengths))])
        return rows

    def entities(self, qi: int) -> np.ndarray:
        """The engine's entity columns: target, reference, the members but
        the reference (5)."""
        g = self.queries.group[qi]
        return np.concatenate([[g[1], g[0]], g[1:6]])

    @torch.no_grad()
    def reference(self, sample, num: ref.Numerics) -> dict:
        """The reference's pooled corpus, and the sampled queries' scores
        against it, computed with ``num``."""
        ref.tf32_off()
        cfg, q, dev = self.cfg, self.queries, self.device
        images = self.corpus.images
        refs = set(int(q.ref[i]) for i in sample)
        pooled, raw = [], {}
        for start in range(0, len(images), 16):
            imgs = torch.from_numpy(images[start:start + 16]).to(dev)
            feats = ref.vit_forward(self.w1, cfg["vit"], imgs, num)
            pooled.append(ref.pooled_image(self.w1, feats, num))
            for j in range(len(imgs)):
                if start + j in refs:
                    raw[start + j] = feats[j]
        pooled = torch.cat(pooled)
        scores = []
        for qi in sample:
            ids, mask = (torch.from_numpy(a).to(dev) for a in
                         ref_text.encode(q.words[qi], self.vocab))
            pred, _ = ref.fused_query(self.w1, cfg, ids, mask,
                                      raw[int(q.ref[qi])][None], num)
            scores.append(num.mm(pred, pooled.t())[0])
        return {"pooled": pooled.cpu().numpy(),
                "scores": torch.stack(scores).cpu().numpy()}

    def program_sample(self, sample, outputs: list[dict]) -> list[dict]:
        return [{"pooled": self.program_pooled if i == len(outputs) - 1
                 else None,
                 "topk": o["topk"][sample], "ranks": o["ranks"][sample]}
                for i, o in enumerate(outputs)]

    def as_program(self, r: dict, sample) -> dict:
        """A reference result in the program's place (the control)."""
        order = np.argsort(-r["scores"], axis=1, kind="stable")
        place = np.argsort(order, axis=1, kind="stable")
        ents = np.stack([self.entities(int(qi)) for qi in sample])
        return {"pooled": r["pooled"],
                "topk": order[:, :self.engine["save_topk_k"]],
                "ranks": np.take_along_axis(place, ents, axis=1)}

    def numbers(self, got: list[dict], want: dict, sample) -> dict:
        pooled = topk = rank = 0.0
        spreads = want["scores"].std(axis=1)
        for g in got:
            if g["pooled"] is not None:
                pooled = max(pooled, compare.rel_err(g["pooled"],
                                                     want["pooled"]))
            for j, qi in enumerate(sample):
                s = want["scores"][j]
                topk = max(topk, compare.order_gap(g["topk"][j], s,
                                                   spreads[j]))
                rank = max(rank, compare.rank_gap(
                    g["ranks"][j], self.entities(int(qi)), s, spreads[j]))
        return {"pooled_rel_err": pooled, "topk_gap": topk,
                "rank_gap": rank}

    def check(self, outputs: list[dict]) -> dict:
        sample = self.sample()
        want = self.reference(sample, ref.FP32)
        return self.numbers(self.program_sample(sample, outputs), want,
                            sample)

    def control(self, lowp: str = "fp8") -> dict:
        sample = self.sample()
        want = self.reference(sample, ref.FP32)
        low = self.reference(sample, ref.Numerics(lowp))
        return self.numbers([self.as_program(low, sample)], want, sample)
