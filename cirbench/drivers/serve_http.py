"""Serving: ``cli/serve.make_http_server`` (a threading HTTP server and the
micro-batcher) over ``runtime/serve.build_serving_index`` of a corpus, with
the re-ranker, at the server's defaults from the workload file.

The window is one open loop: requests arrive as a Poisson process at the
traffic file's fixed rate, sent by a load generator in a child process of
its own (``cirbench/traffic/loadgen.py``), each timed from when it was due
until its answer arrived. Every seed sends the same set of gaps and
caption lengths (stratified quantiles) in its own order, to references
drawn uniformly from the corpus; the window's request count is the rate
times ``--seconds``.

The comparison, on a sample of the answered requests drawn from the seed
(the longest caption in it): the served head, which is the stage-I top-K
(the reference left out) re-ordered and scored by the re-ranker, against
the plain reference: the stage-I set against the reference's own top-K,
the served scores against the reference's logits of the same candidates,
and the served order against the reference's order."""
from __future__ import annotations

import multiprocessing
import threading
import time

import numpy as np
import torch

from cirbench import compare, system
from cirbench.counts import blip as counts
from cirbench.reference import blip as ref
from cirbench.reference import text as ref_text
from cirbench.traffic import cirr, loadgen


def stratified(n: int, rng, draw) -> np.ndarray:
    """``draw`` (an inverse CDF) at the n mid-quantiles, in the order of
    the seed's permutation."""
    u = (np.arange(n) + 0.5) / n
    return draw(u)[rng.permutation(n)]


PHASES = ("window", "warm-up", "trace")   # each draws its own requests


def schedule(traffic: dict, n_images: int, seconds: float, seed: int,
             words: list[str], phase: str = "window") -> list[dict]:
    """A phase's requests: {'due', 'reference' (corpus row), 'words'}."""
    from statistics import NormalDist

    rate = traffic["arrival"]["rate"]
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng([cirr.stream_seed(seed, "queries"),
                                 PHASES.index(phase)])
    gaps = stratified(n, rng, lambda u: -np.log1p(-u) / rate)
    cap = traffic["caption"]
    norm = NormalDist(cap["mean"], cap["std"])
    tokens = stratified(n, rng, lambda u: np.asarray(
        [norm.inv_cdf(x) for x in u]))
    tokens = np.clip(np.round(tokens), cap["min"], cap["max"]).astype(int)
    refs = rng.integers(0, n_images, size=n)
    due = np.cumsum(gaps) - gaps[0]
    return [{"due": float(due[i]), "reference": int(refs[i]),
             "words": list(rng.choice(words, size=int(tokens[i]) - 2))}
            for i in range(n)]


class Cell:
    kernels_per_launch = 1

    def __init__(self, cfg: dict, traffic: dict, engine: dict, seed: int,
                 device: str):
        self.cfg, self.traffic, self.engine = cfg, traffic, engine
        self.seed, self.device = seed, device
        self.sample_size = engine.get("check_requests", 32)
        self.k = traffic["k"]

    # -- set-up ------------------------------------------------------------
    def setup(self, warm: bool = True) -> None:
        from candidate_reranking_cir_tpu_torch.cli.serve import (
            make_http_server,
        )
        from candidate_reranking_cir_tpu_torch.runtime.serve import (
            CIRServingEngine,
            build_serving_index,
        )

        cfg, dev, e = self.cfg, self.device, self.engine
        self.s1, self.w1 = system.build_stage1(cfg, self.seed, dev)
        self.s2, self.w2 = system.build_reranker(cfg, self.seed, dev)
        self.vocab = cirr.load_vocab()
        self.words = cirr.caption_words(self.vocab)
        images = cirr.make_images(self.traffic["images"],
                                  cfg["vit"]["image_size"], self.seed, dev)
        self.corpus = cirr.Corpus(images)
        index = build_serving_index(self.s1, None, self.corpus,
                                    reranker=self.s2,
                                    batch_size=e["batch_size"], device=dev)
        self.server_engine = CIRServingEngine(
            self.s1, None, system.tokenizer(), index,
            text_len=cfg["text_len"], q_pad=e["q_pad"], reranker=self.s2,
            rerank_k=e["rerank_k"], device=dev)
        self.server = make_http_server(self.server_engine, 0,
                                       e["window_ms"])
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        ctx = multiprocessing.get_context("spawn")
        self.conn, child_conn = ctx.Pipe()
        self.child = ctx.Process(target=loadgen.child, args=(child_conn,),
                                 daemon=True)
        self.child.start()
        child_conn.close()
        if warm:
            self.server_engine.warmup()
            # every wave size through HTTP, at the cell's rate
            self.drive(schedule(self.traffic, len(self.corpus),
                                e["warm_seconds"], self.seed, self.words,
                                "warm-up"))

    def drive(self, reqs: list[dict]) -> dict:
        names = self.corpus.index_names
        bodies = [{"caption": " ".join(r["words"]),
                   "reference": names[r["reference"]], "k": self.k}
                  for r in reqs]
        stats0 = self.server.batcher.stats()
        t0 = time.perf_counter()
        self.conn.send(([r["due"] for r in reqs], self.port, bodies))
        if not self.conn.poll(reqs[-1]["due"] + 300.0):
            raise RuntimeError("the load generator did not answer")
        recs = self.conn.recv()
        wall = time.perf_counter() - t0
        stats1 = self.server.batcher.stats()
        return {"queries": len(reqs), "wall": wall, "requests": reqs,
                "records": recs, "stats0": stats0, "stats1": stats1}

    def window(self, seconds: float) -> dict:
        self.reqs = schedule(self.traffic, len(self.corpus), seconds,
                             self.seed, self.words)
        return self.drive(self.reqs)

    def traced(self) -> dict:
        return self.drive(schedule(self.traffic, len(self.corpus),
                                   self.engine["trace_seconds"], self.seed,
                                   self.words, "trace"))

    def failed(self, rec: dict) -> int:
        return sum(r.get("status") != 200 for r in rec["records"])

    def outputs(self, rec: dict) -> dict:
        return rec

    def work(self) -> dict:
        """Counts of one answered request of the traffic's mean length:
        stage-I fusion against its reference, the cosine ranking, z_t and
        ``rerank_k`` pairs, each with its own image K/V (a wave's requests
        rarely share a candidate)."""
        cap = self.traffic["caption"]
        length = int(round(cap["mean"]))
        m = counts.image_tokens(self.cfg["vit"])
        text = self.cfg["text"]
        c = counts.Counts()
        for _ in range(2):                      # stage-I fusion, then z_t
            c.add(counts.med_query(text, length, m))
            c.add(counts.med_image_kv(text, m))
        c.flops += counts.linear(1, text["hidden_size"],
                                 self.cfg["embed_dim"])
        c.flops += counts.linear(1, self.cfg["embed_dim"],
                                 self.traffic["images"])
        kk = self.engine["rerank_k"]
        c.add(counts.dual_pair(text, length, m), kk)
        c.add(counts.dual_candidate_kv(text, m), kk)
        return {**c.as_dict(), "unit": "request"}

    def release(self) -> None:
        """Stops the server, its batcher and the load generator; frees the
        program's models and index."""
        self.conn.send(None)
        self.child.join(30)
        if self.child.is_alive():
            self.child.terminate()
            self.child.join(10)
        self.server.shutdown()
        self.server.server_close()
        self.server.batcher.close()
        self.thread.join(10)
        del self.server, self.server_engine, self.s1, self.s2

    # -- the comparison ----------------------------------------------------
    def sample(self, rec: dict) -> np.ndarray:
        ok = np.flatnonzero([r.get("status") == 200 for r in rec["records"]])
        if len(ok) == 0:
            return ok
        lengths = np.asarray([len(self.reqs[i]["words"]) for i in ok])
        rows = cirr.sample_rows(len(ok), self.sample_size, self.seed,
                                must=[int(np.argmax(lengths))])
        return ok[rows]

    @torch.no_grad()
    def reference(self, reqs: list[dict], num: ref.Numerics,
                  served: list[list[int]] | None = None) -> dict:
        """For each request: the reference's stage-I scores over the corpus
        (its reference left out), and its re-ranker logits of ``served``
        candidates (default: its own stage-I top-K)."""
        ref.tf32_off()
        cfg, dev = self.cfg, self.device
        images = self.corpus.images
        need1 = {r["reference"] for r in reqs}
        pooled, raw1 = [], {}
        for start in range(0, len(images), 16):
            imgs = torch.from_numpy(images[start:start + 16]).to(dev)
            feats = ref.vit_forward(self.w1, cfg["vit"], imgs, num)
            pooled.append(ref.pooled_image(self.w1, feats, num))
            for j in range(len(imgs)):
                if start + j in need1:
                    raw1[start + j] = feats[j]
        pooled = torch.cat(pooled)
        s1_scores, topk = [], []
        for r in reqs:
            ids, mask = (torch.from_numpy(a).to(dev) for a in
                         ref_text.encode(r["words"], self.vocab))
            pred, _ = ref.fused_query(self.w1, cfg, ids, mask,
                                      raw1[r["reference"]][None], num)
            s = num.mm(pred, pooled.t())[0].cpu().numpy().astype(np.float64)
            s[r["reference"]] = -np.inf
            s1_scores.append(s)
            topk.append(np.argsort(-s, kind="stable")[:self.k])
        served = topk if served is None else served
        need2 = sorted({r["reference"] for r in reqs}
                       | {int(c) for row in served for c in row})
        feats2 = {}
        for start in range(0, len(need2), 8):
            idx = need2[start:start + 8]
            imgs = torch.from_numpy(images[idx]).to(dev)
            for i, f in zip(idx, ref.vit_forward(self.w2, cfg["vit"], imgs,
                                                 num)):
                feats2[i] = f
        logits = []
        for r, cands in zip(reqs, served):
            ids, mask = (torch.from_numpy(a).to(dev) for a in
                         ref_text.encode(r["words"], self.vocab))
            _, z_t = ref.fused_query(self.w1, cfg, ids, mask,
                                     feats2[r["reference"]][None], num)
            logits.append(ref.rerank_scores(
                self.w2, cfg["text"], ids, mask, z_t,
                torch.stack([feats2[int(c)] for c in cands]),
                num).cpu().numpy())
        return {"s1_scores": s1_scores, "topk": topk, "logits": logits}

    def served(self, rec: dict, sample) -> dict:
        pos = {nm: i for i, nm in enumerate(self.corpus.index_names)}
        rows = [rec["records"][i]["answer"] for i in sample]
        return {"ranking": [[pos[nm] for nm in a["ranking"]] for a in rows],
                "scores": [np.asarray(a["scores"], np.float64) for a in rows]}

    @staticmethod
    def as_served(low: dict) -> dict:
        """The reference at a lower precision in the server's place."""
        ranking, scores = [], []
        for cands, lg in zip(low["topk"], low["logits"]):
            order = np.argsort(-lg, kind="stable")
            ranking.append([int(cands[j]) for j in order])
            scores.append(np.asarray(lg, np.float64)[order])
        return {"ranking": ranking, "scores": scores}

    def numbers(self, got: dict, reqs: list[dict]) -> dict:
        """Compares ``got`` (served rankings and scores) with the fp32
        reference of its own candidates."""
        want = self.reference(reqs, ref.FP32, served=got["ranking"])
        logit_spread = float(np.concatenate(want["logits"]).std())
        s1 = logit = gap = 0.0
        for j, r in enumerate(reqs):
            s = want["s1_scores"][j]
            finite = s[np.isfinite(s)]
            mine = np.sort(s[got["ranking"][j]])[::-1]
            best = np.sort(finite)[::-1][:len(mine)]
            s1 = max(s1, float(np.abs(best - mine).max() / finite.std()))
            logit = max(logit, compare.value_err(got["scores"][j],
                                                 want["logits"][j],
                                                 logit_spread))
            # the served order is best first: position i of the served list
            gap = max(gap, compare.order_gap(
                np.arange(len(got["ranking"][j])), want["logits"][j],
                logit_spread))
        return {"stage1_gap": s1, "logit_err": logit, "rank_gap": gap}

    def check(self, outputs: list[dict]) -> dict:
        rec = outputs[-1]
        sample = self.sample(rec)
        if len(sample) == 0:
            return {"stage1_gap": np.inf, "logit_err": np.inf,
                    "rank_gap": np.inf}
        reqs = [self.reqs[i] for i in sample]
        return self.numbers(self.served(rec, sample), reqs)

    def control(self, lowp: str = "fp8", seconds: float = 30.0) -> dict:
        self.reqs = schedule(self.traffic, len(self.corpus), seconds,
                             self.seed, self.words)
        rec = {"records": [{"status": 200} for _ in self.reqs]}
        sample = self.sample(rec)
        reqs = [self.reqs[i] for i in sample]
        low = self.reference(reqs, ref.Numerics(lowp))
        return self.numbers(self.as_served(low), reqs)
