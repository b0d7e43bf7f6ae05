"""Stage-I evaluation of BLIP-2 (EVA ViT-g/14 + Q-Former):
``retrieval/validate_engine.evaluate_cirr_stage1`` with the port's
``Blip2RetrievalModel`` over an in-memory CIRR-shaped split.

One call is one whole evaluation: the ViT-g and ``ln_vision`` over the
corpus (the layer span 'index'), the Q-Former's query pass and
``vision_proj`` over every image (32 targets an image, 'targets'), the
image-major fusion of every caption ('fusion'), and the exact ranking of
every query against the corpus by its best target ('ranking': the
top-``save_topk_k`` lists and the entity ranks).

The comparison, against the plain reference ``cirbench/reference/blip2``
on the same weights: every corpus image's 32 normalised targets as the
timed path produced them in the last call (``target_rel_err``, the worst
row), and for a sample of queries drawn from the seed (the longest
caption in it) every call's top-K list and entity ranks (``topk_gap``,
``rank_gap``, as stage I's), which cover the fused queries."""
from __future__ import annotations

import torch

from cirbench import system
from cirbench.counts import blip2 as counts
from cirbench.drivers import stage1_eval
from cirbench.reference import blip as ref_blip
from cirbench.reference import blip2 as ref
from cirbench.traffic import cirr


def port_config(cfg: dict):
    from candidate_reranking_cir_tpu_torch.config import (
        Blip2RetrievalModelConfig,
        TextEncoderConfig,
        ViTConfig,
    )

    v, t = cfg["vit"], cfg["text"]
    return Blip2RetrievalModelConfig(
        vit=ViTConfig(**{k: v[k] for k in (
            "image_size", "patch_size", "hidden_size", "num_layers",
            "num_heads", "mlp_ratio", "layer_norm_eps", "qkv_bias",
            "final_norm_eps")}),
        text=TextEncoderConfig(**{k: t[k] for k in (
            "vocab_size", "hidden_size", "num_layers", "num_heads",
            "intermediate_size", "max_position_embeddings", "encoder_width",
            "layer_norm_eps", "hidden_dropout", "attention_dropout")}),
        num_query_tokens=cfg["num_query_tokens"],
        cross_attention_freq=cfg["cross_attention_freq"],
        embed_dim=cfg["embed_dim"], text_len=cfg["text_len"])


class Cell(stage1_eval.Cell):

    def setup(self, warm: bool = True) -> None:
        # first, so that a program without BLIP-2 fails at once
        from candidate_reranking_cir_tpu_torch.models.blip2_retrieval import (
            Blip2RetrievalModel,
        )
        from candidate_reranking_cir_tpu_torch.retrieval.validate_engine \
            import evaluate_cirr_stage1

        self.evaluate = evaluate_cirr_stage1
        cfg, dev = self.cfg, self.device
        self.w1 = ref_blip.make_weights(
            ref.blip2_shapes(cfg), cirr.stream_seed(self.seed,
                                                    "weights_stage1"), dev)
        self.model = Blip2RetrievalModel(
            port_config(cfg), dtype=system.DTYPES[cfg["dtype"]],
            device=dev)
        self.model.load_state_dict(self.w1, strict=True)
        self.model.eval()
        self.tok = system.tokenizer()
        self.tok.overflow = "truncate"       # LAVIS's truncation=True
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

    def work(self) -> dict:
        q = self.queries
        c = counts.stage1_eval_call(self.cfg, len(self.corpus), q.lengths,
                                    len(q.ref))
        return {**c, "images": len(self.corpus), "queries": len(q.ref)}

    def release(self) -> None:
        """Frees the program's model; keeps its targets, one row each."""
        super().release()
        self.program_pooled = self.program_pooled.reshape(
            -1, self.program_pooled.shape[-1])

    @torch.no_grad()
    def reference(self, sample, num: ref_blip.Numerics) -> dict:
        """The reference's targets of the corpus (one row each), and the
        sampled queries' scores against them, computed with ``num``."""
        ref_blip.tf32_off()
        cfg, q, dev = self.cfg, self.queries, self.device
        images = self.corpus.images
        refs = set(int(q.ref[i]) for i in sample)
        tgt, raw = [], {}
        for start in range(0, len(images), 16):
            imgs = torch.from_numpy(images[start:start + 16]).to(dev)
            feats = ref.vision(self.w1, cfg["vit"], imgs, num)
            tgt.append(ref.targets(self.w1, cfg, feats, num))
            for j in range(len(imgs)):
                if start + j in refs:
                    raw[start + j] = feats[j]
        tgt = torch.cat(tgt)
        scores = []
        for qi in sample:
            ids, mask = (torch.from_numpy(a).to(dev) for a in ref.encode(
                q.words[qi], self.vocab, cfg["text_len"]))
            f_q = ref.fused_query(self.w1, cfg, ids, mask,
                                  raw[int(q.ref[qi])][None], num)
            scores.append(ref.scores(num, f_q, tgt)[0])
        return {"pooled": tgt.reshape(-1, tgt.shape[-1]).cpu().numpy(),
                "scores": torch.stack(scores).cpu().numpy()}

    def numbers(self, got: list[dict], want: dict, sample) -> dict:
        out = super().numbers(got, want, sample)
        return {"target_rel_err": out.pop("pooled_rel_err"), **out}
