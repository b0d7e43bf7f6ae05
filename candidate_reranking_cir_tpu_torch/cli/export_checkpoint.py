"""Export a trained checkpoint to the reference's torch format (port of
the JAX package's ``cli/export_checkpoint.py``).

  python -m candidate_reranking_cir_tpu_torch.cli.export_checkpoint \\
      --stage 1 --checkpoint models/exp/saved_models/blip_mean \\
      --out blip_mean.pt [--model-config cfg.json] [--device cpu]

``--checkpoint`` is what ``cli/common.load_params`` reads: a checkpoint
directory of the port's trainers, or a reference-format ``.pt``. The
weights are loaded into the stage's model on ``--device`` (strictly, so a
checkpoint of another configuration is refused) and written with
``runtime/convert.export_stage1/2`` and ``save_torch_checkpoint`` under
``BLIP_Retrieval`` (stage I) or ``BLIP_NLVR`` (stage II). The output
loads in the reference code via its normal state-dict path
(validate.py:389-390 / validate_stage2.py:347-360). An Orbax checkpoint of
the JAX package is exported by the JAX package's own exporter.
"""
from __future__ import annotations

import argparse

from candidate_reranking_cir_tpu_torch.cli.common import (
    build_stage1,
    build_stage2,
    load_params,
)
from candidate_reranking_cir_tpu_torch.runtime import convert


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--vit", type=str, default="base")
    parser.add_argument("--image-size", type=int, default=384)
    parser.add_argument("--text-len", type=int, default=40)
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--no-bf16", dest="bf16", action="store_false")
    parser.add_argument("--model-config", type=str, default="")
    parser.add_argument("--stage", type=int, required=True, choices=(1, 2))
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--epoch", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the model is built and the weights "
                             "checked (default: the CUDA card)")
    # what build_stage1/2 read besides: one device, the kernels' routes
    parser.set_defaults(fused_attention="auto", mesh="off")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    build, export, class_name = {
        1: (build_stage1, convert.export_stage1, "BLIP_Retrieval"),
        2: (build_stage2, convert.export_stage2, "BLIP_NLVR"),
    }[args.stage]
    model, cfg = build(args)
    model.load_state_dict(load_params(args.checkpoint, args.stage, cfg),
                          strict=True)
    sd = export(model.state_dict())
    convert.save_torch_checkpoint(args.out, sd, class_name, epoch=args.epoch)
    print(f"wrote {args.out} ({class_name}, {len(sd)} tensors)")


if __name__ == "__main__":
    main()
