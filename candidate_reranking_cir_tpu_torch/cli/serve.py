"""CIR serving CLI (port of the JAX package's ``cli/serve.py``): load the
trained two-stage stack, build (or load) the corpus index once, then answer
(reference image, modification text) queries on the card.

Two transports:

- ``--mode stdio``: one JSON request per stdin line -> one JSON result per
  stdout line. For piping and smoke tests.
- ``--mode http``: a threaded HTTP server; concurrent POST /rank requests
  are coalesced by the micro-batcher into waves of --q-pad. GET /healthz
  for liveness, GET /statsz for the batcher's counters
  (``MicroBatcher.stats()``: requests, waves, errors, wave occupancy,
  latency percentiles, and the cumulative seconds ``queue_wait_s`` from
  enqueue to wave, ``wave_s`` in the waves, ``device_wait_s`` of the waves
  blocked on the card and ``idle_s`` of the worker waiting for requests),
  POST /admin/add and /admin/remove behind --enable-admin.

Request: {"caption": str, "reference": corpus-image-name, "k": int}
         (or "reference_path": path to a new image file)
Response: {"ranking": [names...], "scores": [...], "reranked": int}

Example:
  python -m candidate_reranking_cir_tpu_torch.cli.serve --dataset CIRR \
      --data-root /data --stage1-path s1.pt --stage2-path s2.pt \
      --vocab vocab.txt --index-cache cirr_val_index.npz --mode http \
      --port 8080 --device cuda
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from candidate_reranking_cir_tpu_torch.cli.common import (
    add_common_flags,
    build_stage1,
    build_stage2,
    get_device,
    get_tokenizer,
    get_transform,
    load_params,
)
from candidate_reranking_cir_tpu_torch.data.datasets import (
    CIRRDataset,
    FashionIQDataset,
)
from candidate_reranking_cir_tpu_torch.runtime.host import (
    limit_numpy_threads,
)
from candidate_reranking_cir_tpu_torch.runtime.serve import (
    CIRServingEngine,
    MicroBatcher,
    ServeRequest,
    ServingIndex,
    build_serving_index,
    params_fingerprint,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--stage1-path", type=str, required=True)
    parser.add_argument("--stage2-path", type=str, default="",
                        help="optional re-ranker checkpoint; enables "
                             "stage-II re-scoring of each query's head")
    parser.add_argument("--split", type=str, default="val",
                        help="corpus split to index")
    parser.add_argument("--index-cache", type=str, default="",
                        help="npz path: load the corpus index if it exists, "
                             "else build and save it")
    parser.add_argument("--rerank-k", type=int, default=50)
    parser.add_argument("--index-int8", action="store_true",
                        help="quantize the raw token banks to per-token "
                             "symmetric int8 (about half the corpus memory; "
                             "scores shift by under 1%%, see ops/quant.py)")
    parser.add_argument("--q-pad", type=int, default=4,
                        help="query-batch width per wave")
    parser.add_argument("--batch-size", type=int, default=16,
                        help="index-build embed batch")
    parser.add_argument("--mode", type=str, default="stdio",
                        choices=["stdio", "http"])
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--window-ms", type=float, default=3.0,
                        help="http micro-batch coalescing window")
    parser.add_argument("--enable-admin", action="store_true",
                        help="expose POST /admin/add and /admin/remove for "
                             "incremental corpus updates (no auth: front "
                             "with a real gateway in production)")
    return parser.parse_args(argv)


def make_engine(args) -> CIRServingEngine:
    tokenizer = get_tokenizer(args)  # cheap fail-fast before ckpt IO
    device = get_device(args)
    stage1, s1_cfg = build_stage1(args)
    s1_params = load_params(args.stage1_path, 1, s1_cfg)
    reranker = s2_params = None
    if args.stage2_path:
        reranker, s2_cfg = build_stage2(args)
        s2_params = load_params(args.stage2_path, 2, s2_cfg)
    transform = get_transform(args)

    fingerprint = {
        "dataset": args.dataset.lower(), "split": args.split,
        "image_size": args.image_size, "transform": args.transform,
        "target_ratio": args.target_ratio,
        "stage1": params_fingerprint(s1_params),
        "stage2": params_fingerprint(s2_params) if s2_params is not None
        else None,
    }
    if args.index_cache and Path(args.index_cache).exists():
        index = ServingIndex.load(args.index_cache,
                                  expect_fingerprint=fingerprint,
                                  device=device)
        if reranker is not None and index.raw_s2 is None:
            raise ValueError(f"{args.index_cache} has no stage-II features; "
                             "rebuild it with --stage2-path set")
        print(f"index loaded: {len(index.names)} images", file=sys.stderr)
    else:
        if args.dataset.lower() == "cirr":
            classic = CIRRDataset(args.data_root, args.split, "classic",
                                  transform)
        else:
            classic = FashionIQDataset(args.data_root, args.split,
                                       list(args.dress_types), "classic",
                                       transform)
        index = build_serving_index(stage1, s1_params, classic,
                                    reranker=reranker, s2_params=s2_params,
                                    batch_size=args.batch_size,
                                    device=device)
        index.fingerprint = fingerprint
        if args.index_cache:
            index.save(args.index_cache)
            print(f"index cached at {args.index_cache}", file=sys.stderr)
        print(f"index built: {len(index.names)} images", file=sys.stderr)

    if args.index_int8:
        index.quantize()
        print("index banks quantized to int8", file=sys.stderr)
    return CIRServingEngine(
        stage1, s1_params, tokenizer, index, text_len=args.text_len,
        q_pad=args.q_pad, reranker=reranker, s2_params=s2_params,
        rerank_k=args.rerank_k, transform=transform, device=device)


def _load_image(engine, path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(engine.transform(im), np.float32)


def request_from_json(engine, obj) -> ServeRequest:
    if not isinstance(obj, dict) or not obj.get("caption"):
        raise ValueError('request must be a JSON object with a "caption"')
    if not obj.get("reference") and not obj.get("reference_path"):
        raise ValueError('request needs "reference" (a corpus image name) '
                         'or "reference_path" (an image file)')
    ref_img = None
    if obj.get("reference_path"):
        ref_img = _load_image(engine, obj["reference_path"])
    return ServeRequest(caption=obj["caption"],
                        reference=obj.get("reference"),
                        reference_image=ref_img,
                        k=int(obj.get("k", 50)))


def result_to_json(res) -> dict:
    return {"ranking": res.ranking, "scores": res.scores,
            "reranked": res.reranked}


def admin_add(engine, obj) -> dict:
    """{"names": [...], "paths": [...]} -> decode and preprocess each image
    with the serving transform, embed, and index. Returns the corpus
    size."""
    names = obj.get("names") or []
    paths = obj.get("paths") or []
    if not names or len(names) != len(paths):
        raise ValueError('"names" and "paths" must be non-empty lists of '
                         "equal length")
    images = [_load_image(engine, p) for p in paths]
    engine.add_images(names, np.stack(images))
    return {"added": len(names), "corpus": engine.index.n_valid}


def admin_remove(engine, obj) -> dict:
    names = obj.get("names") or []
    if not names:
        raise ValueError('"names" must be a non-empty list')
    engine.remove_images(names)
    return {"removed": len(names), "corpus": engine.index.n_valid}


def serve_stdio(engine):
    """Answer one JSON request a stdin line with one JSON line on stdout;
    "ready" goes to stderr after the warm-up."""
    engine.warmup()
    print("ready", file=sys.stderr, flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = request_from_json(engine, json.loads(line))
            res = engine.handle([req])[0]
            print(json.dumps(result_to_json(res)), flush=True)
        except Exception as e:  # one bad line answers with its error
            print(json.dumps({"error": str(e)}), flush=True)


def make_http_server(engine, port: int, window_ms: float,
                     enable_admin: bool = False):
    """ThreadingHTTPServer + micro-batcher, returned unstarted so that
    callers can drive it on an ephemeral port (``port`` 0). Admin
    endpoints run on the batcher's worker thread strictly between waves.
    ``server.batcher.close()`` stops the worker."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = MicroBatcher(engine, window_ms=window_ms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "corpus": len(engine.index.names)})
            elif self.path == "/statsz":
                self._send(200, batcher.stats())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                obj = json.loads(self.rfile.read(n))
            except ValueError as e:  # bad length or JSON
                self._send(400, {"error": str(e)})
                return
            try:
                if self.path == "/rank":
                    res = batcher.submit(request_from_json(engine, obj))
                    self._send(200, result_to_json(res))
                elif self.path == "/admin/add" and enable_admin:
                    self._send(200, batcher.submit_admin(
                        lambda: admin_add(engine, obj)))
                elif self.path == "/admin/remove" and enable_admin:
                    self._send(200, batcher.submit_admin(
                        lambda: admin_remove(engine, obj)))
                else:
                    self._send(404, {"error": "not found"})
            except Exception as e:  # the request's own fault, answered
                self._send(400, {"error": str(e)})

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    server.batcher = batcher
    return server


def main(argv=None):
    limit_numpy_threads()
    args = parse_args(argv)
    engine = make_engine(args)
    if args.mode == "stdio":
        serve_stdio(engine)
    else:
        engine.warmup()
        server = make_http_server(engine, args.port, args.window_ms,
                                  enable_admin=args.enable_admin)
        print(f"serving on :{args.port}", file=sys.stderr, flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.batcher.close()
            server.server_close()


if __name__ == "__main__":
    main()
