"""Self-contained quickstart of the port (port of the JAX package's
``demo.py``): a synthetic CIRR-format dataset, then the whole two-stage
pipeline with tiny models, through the port's CLIs in-process:

  stage-I training (1 epoch) -> top-k extraction -> stage-II training
  (1 epoch) -> stage-II re-rank validation -> test1 submission JSONs ->
  one served query

No downloads, no real data; the captions go through the unit-test
vocabulary (``--allow-test-vocab``), so the metrics are meaningless:

  python -m candidate_reranking_cir_tpu_torch.demo --device cpu|cuda \\
      [--workdir DIR]

On the card the tiny models' 6-wide heads run the attention kernels
zero-padded to their 64-wide heads (``ops/cuda_attention.pad_heads``).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import numpy as np

MODEL_CONFIG = {
    "vit": {"image_size": 32, "patch_size": 8, "hidden_size": 24,
            "num_layers": 2, "num_heads": 4},
    "text": {"vocab_size": 256, "hidden_size": 24, "num_layers": 2,
             "num_heads": 4, "intermediate_size": 48, "encoder_width": 24,
             "merge_mlp_from": 1},
    "embed_dim": 16,
}

# what the JAX package's demo writes under its workdir (but the insides
# of its Orbax checkpoint directories; the port's trainers write a
# train_state.pt there): the same names, the port's formats
ARTIFACTS = (
    "model_config.json",
    *(f"cirr_dataset/cirr/{kind}.rc2.{split}.json"
      for kind in ("captions/cap", "image_splits/split")
      for split in ("train", "val", "test1")),
    *(f"cirr_dataset/img/im{i}.jpg" for i in range(16)),
    "cirr_top_8_val.npz", "cirr_top_4_test1.npz",
    *(f"models/{exp}/{name}" for exp in ("demo_s1", "demo_s2")
      for name in (f"{exp}.json", "train_metrics.csv",
                   "validation_metrics.csv",
                   "saved_models/blip_last/framework_metadata.json",
                   "saved_models/blip_mean/framework_metadata.json")),
    *(f"submission/recall{subset}_submission_{name}.json"
      for subset in ("", "_subset") for name in ("demo", "demo_stage2")),
)

CAPTION_BANK = [
    "make the dress red with short sleeves",
    "same shirt but blue and striped",
    "a dog instead of a cat on the image",
    "longer and darker with a belt",
    "brighter background and two people",
    "the same image but zoomed out",
]


def build_dataset(root: Path, n_images=16, n_train=12, n_val=6, n_test=6):
    """The synthetic CIRR tree (random jpegs, captions, splits) and the
    tiny models' ``model_config.json`` under ``root``."""
    import PIL.Image

    base = root / "cirr_dataset"
    (base / "cirr" / "captions").mkdir(parents=True, exist_ok=True)
    (base / "cirr" / "image_splits").mkdir(parents=True, exist_ok=True)
    (base / "img").mkdir(exist_ok=True)

    rng = np.random.default_rng(0)
    names = [f"im{i}" for i in range(n_images)]
    relpath = {}
    for i, n in enumerate(names):
        arr = rng.integers(0, 255, size=(40 + i % 7, 30 + i % 11, 3),
                           dtype=np.uint8)
        PIL.Image.fromarray(arr).save(base / "img" / f"{n}.jpg", quality=90)
        relpath[n] = f"img/{n}.jpg"

    def triplets(count, split):
        out = []
        for q in range(count):
            ref, tgt = names[q % n_images], names[(q + 5) % n_images]
            members = [ref, tgt] + [names[(q + 7 + j) % n_images]
                                    for j in range(4)]
            t = {"pairid": q, "reference": ref,
                 "caption": CAPTION_BANK[q % len(CAPTION_BANK)],
                 "img_set": {"members": members}}
            if split != "test1":
                t["target_hard"] = tgt
            out.append(t)
        return out

    for split, count in (("train", n_train), ("val", n_val),
                         ("test1", n_test)):
        with open(base / "cirr" / "captions" / f"cap.rc2.{split}.json",
                  "w") as f:
            json.dump(triplets(count, split), f)
        with open(base / "cirr" / "image_splits" / f"split.rc2.{split}.json",
                  "w") as f:
            json.dump(relpath, f)
    (root / "model_config.json").write_text(json.dumps(MODEL_CONFIG))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", type=str,
                        default=os.path.join(tempfile.gettempdir(),
                                             "cir_demo"))
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where every stage runs (default: the CUDA "
                             "card)")
    args = parser.parse_args(argv)
    root = Path(args.workdir)
    root.mkdir(parents=True, exist_ok=True)

    print("== generating synthetic CIRR dataset ==")
    build_dataset(root)

    # the unit-test vocabulary (near char-level), where these captions
    # need ~30 wordpieces: truncation is fine for a synthetic demo
    # (production runs take a real vocab and the fail-loud overflow policy)
    common = ["--dataset", "CIRR", "--data-root", str(root),
              "--image-size", "32", "--text-len", "12", "--no-bf16",
              "--text-overflow", "truncate", "--allow-test-vocab",
              "--model-config", str(root / "model_config.json"),
              "--device", args.device]

    from candidate_reranking_cir_tpu_torch.cli import (
        cirr_test_submission,
        cirr_test_submission_stage2,
        stage1_train,
        stage2_train,
        validate,
        validate_stage2,
    )

    print("\n== stage-I training (1 epoch) ==")
    stage1_train.main(common + [
        "--experiment-name", "demo_s1", "--output-dir", str(root / "models"),
        "--num-epochs", "1", "--batch-size", "4", "--blip-max-epoch", "2"])
    s1 = str(root / "models" / "demo_s1" / "saved_models" / "blip_mean")

    print("\n== stage-I validation + top-k extraction ==")
    topk = str(root / "cirr_top_8_val.npz")
    validate.main(common + ["--stage1-path", s1, "--save-topk", "--k", "8",
                            "--topk-out", topk, "--batch-size", "4"])

    print("\n== stage-II training (1 epoch) ==")
    stage2_train.main(common + [
        "--experiment-name", "demo_s2", "--output-dir", str(root / "models"),
        "--stage1-path", s1, "--top-k-path", topk, "--K-value", "4",
        "--num-epochs", "1", "--batch-size", "4", "--blip-max-epoch", "2"])
    s2 = str(root / "models" / "demo_s2" / "saved_models" / "blip_mean")

    print("\n== stage-II re-rank validation ==")
    validate_stage2.main(common + [
        "--stage1-path", s1, "--stage2-path", s2,
        "--top-k-path", topk, "--K-value", "4", "--q-batch", "4"])

    print("\n== test1 submissions ==")
    t1_topk = str(root / "cirr_top_4_test1.npz")
    cirr_test_submission.main(common + [
        "--stage1-path", s1, "--submission-name", "demo",
        "--out-dir", str(root / "submission"), "--save-topk", "--k", "4",
        "--topk-out", t1_topk, "--batch-size", "4"])
    cirr_test_submission_stage2.main(common + [
        "--stage1-path", s1, "--stage2-path", s2,
        "--top-k-path", t1_topk, "--K-value", "4",
        "--submission-name", "demo_stage2",
        "--out-dir", str(root / "submission"), "--q-batch", "4",
        "--batch-size", "4"])

    print("\n== online serving (in-process) ==")
    from candidate_reranking_cir_tpu_torch.cli import serve as serve_cli

    serve_args = serve_cli.parse_args(common + [
        "--stage1-path", s1, "--stage2-path", s2, "--split", "val",
        "--rerank-k", "4", "--q-pad", "2", "--batch-size", "4"])
    engine = serve_cli.make_engine(serve_args)
    engine.warmup()
    req = serve_cli.request_from_json(engine, {
        "caption": CAPTION_BANK[0],
        "reference": engine.index.names[0], "k": 5})
    res = engine.handle([req])[0]
    print(f"query: {CAPTION_BANK[0]!r} (reference "
          f"{engine.index.names[0]})")
    print(f"  -> top-{len(res.ranking)}: {res.ranking} "
          f"(stage-II re-scored head: {res.reranked})")

    print(f"\ndemo complete — artifacts under {root}")
    return res


if __name__ == "__main__":
    main()
