"""The port's serving path (``runtime/serve.py``, ``cli/serve.py``) against
the JAX package's.

- ``CIRServingEngine.handle`` against JAX's engine on the same index data:
  stage I alone and with the re-ranker, several waves (q_pad 3, 7
  requests), an uploaded reference, per-request k, an int8 index.
  Rankings equal, stage-I scores within 1e-5, re-ranked scores within
  1e-4.
- Corpus updates: an index grown by ``add_images`` and cut by
  ``remove_images`` serves as a fresh build of the same corpus does.
- The npz cache: the port's round trip, a JAX-written cache read by the
  port (arrays equal) and back, a fingerprint mismatch refused.
- ``_validate``'s messages are JAX's.
- ``MicroBatcher``: concurrent callers get what the engine gives each
  request alone; a bad request fails alone; closing fails what is queued.
- HTTP end to end on an ephemeral port, with the admin endpoints.
- ``cli/serve --mode stdio --device cpu`` on a jpeg CIRR tree against the
  JAX ``cli.serve`` on the same tree and weights.

The models are tests/test_torch_port_e2e.py's (JAX with its Pallas kernels
interpreted on the CPU, the port holding the same weights)."""
import io
import json
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from candidate_reranking_cir_tpu.runtime import serve as jserve
from candidate_reranking_cir_tpu_torch.data.preprocessing import (
    make_transform,
)
from candidate_reranking_cir_tpu_torch.runtime import serve as tserve
from test_torch_port_e2e import IMG, TEXT_LEN, models, tokenizers  # noqa: F401

N, EMBED, WIDTH = 10, 16, 24
M_TOKENS = (IMG // 8) ** 2 + 1
STAGE1_ATOL, STAGE2_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def index_data():
    rng = np.random.default_rng(0)
    pooled = rng.normal(size=(N, EMBED)).astype(np.float32)
    pooled /= np.linalg.norm(pooled, axis=-1, keepdims=True)
    return {"names": [f"im{i}" for i in range(N)], "pooled": pooled,
            "raw1": (rng.normal(size=(N, M_TOKENS, WIDTH)) * 0.1)
            .astype(np.float32),
            "raw2": (rng.normal(size=(N, M_TOKENS, WIDTH)) * 0.1)
            .astype(np.float32),
            "upload": (rng.normal(size=(IMG, IMG, 3)) * 0.3)
            .astype(np.float32)}


def jax_index(d):
    return jserve.ServingIndex(
        names=list(d["names"]), pooled_s1=jnp.asarray(d["pooled"]),
        raw_s1=jnp.asarray(d["raw1"]), raw_s2=jnp.asarray(d["raw2"]))


def port_index(d):
    return tserve.ServingIndex(
        names=list(d["names"]), pooled_s1=torch.tensor(d["pooled"]),
        raw_s1=torch.tensor(d["raw1"]), raw_s2=torch.tensor(d["raw2"]))


def engines(models, tokenizers, jidx, tidx, rerank, q_pad=3):
    j1, p1, j2, p2, t1, t2 = models
    jt, tt = tokenizers
    kw = dict(text_len=TEXT_LEN, q_pad=q_pad, rerank_k=4, max_k=N)
    jeng = jserve.CIRServingEngine(
        j1, p1, jt, jidx, reranker=j2 if rerank else None,
        s2_params=p2 if rerank else None, **kw)
    teng = tserve.CIRServingEngine(
        t1, None, tt, tidx, reranker=t2 if rerank else None, device="cpu",
        **kw)
    return jeng, teng


def requests(mod, d):
    """7 requests (three waves at q_pad 3): corpus references with k from 2
    to N - 1, and one uploaded reference image."""
    reqs = [mod.ServeRequest(caption=cap, reference=f"im{i}", k=k)
            for i, (cap, k) in enumerate([
                ("red dress", 5), ("a blue shirt", 9), ("the dog", 2),
                ("same cat with a red hat", 6), ("blue", 8),
                ("a shirt and a dress", 4)])]
    reqs.insert(3, mod.ServeRequest(caption="uploaded image",
                                    reference_image=d["upload"], k=7))
    return reqs


def assert_same_results(out, ref):
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.ranking == r.ranking and o.reranked == r.reranked
        head = r.reranked
        np.testing.assert_allclose(o.scores[:head], r.scores[:head],
                                   atol=STAGE2_ATOL)
        np.testing.assert_allclose(o.scores[head:], r.scores[head:],
                                   atol=STAGE1_ATOL)


@pytest.mark.parametrize("rerank,int8", [(False, False), (True, False),
                                         (True, True)],
                         ids=["stage1", "rerank", "rerank_int8"])
def test_engine_matches_jax(models, tokenizers, index_data, rerank, int8):
    jidx, tidx = jax_index(index_data), port_index(index_data)
    if int8:
        jidx.quantize()
        tidx.quantize()
        np.testing.assert_array_equal(tidx.raw_s2.q.numpy(),
                                      np.asarray(jidx.raw_s2.q))
    jeng, teng = engines(models, tokenizers, jidx, tidx, rerank)
    ref = jeng.handle(requests(jserve, index_data))
    out = teng.handle(requests(tserve, index_data))
    assert_same_results(out, ref)
    assert [o.reranked for o in out] == (
        [4, 4, 2, 0, 4, 4, 4] if rerank else [0] * 7)
    assert "im0" not in out[0].ranking and len(out[3].ranking) == 7


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(9)
    names = [f"img{i}" for i in range(12)]
    return names, (rng.normal(size=(12, IMG, IMG, 3)) * 0.3).astype(
        np.float32)


class MemDataset:
    """In-memory 'classic' dataset."""

    def __init__(self, names, images):
        self.index_names, self.images = names, images

    def __len__(self):
        return len(self.index_names)

    def __getitem__(self, i):
        return {"name": self.index_names[i], "image": self.images[i]}


def port_engine(models, tokenizers, index, **kw):
    *_, t1, t2 = models
    kw = {"text_len": TEXT_LEN, "q_pad": 2, "reranker": t2, "rerank_k": 4,
          "max_k": 12, "device": "cpu", **kw}
    return tserve.CIRServingEngine(t1, None, tokenizers[1], index, **kw)


def test_incremental_updates_match_fresh_index(models, tokenizers, corpus):
    *_, t1, t2 = models
    names, imgs = corpus
    build = lambda n: tserve.build_serving_index(  # noqa: E731
        t1, None, MemDataset(names[:n], imgs[:n]), reranker=t2,
        batch_size=4, device="cpu")
    full, inc = build(12), build(8)
    eng_full = port_engine(models, tokenizers, full)
    eng_inc = port_engine(models, tokenizers, inc)
    assert inc.capacity == 8
    eng_inc.add_images(names[8:], imgs[8:])
    assert inc.capacity == 16 and inc.n_valid == 12
    req = tserve.ServeRequest(caption="a red dress", reference="img2", k=8)
    res_full, res_inc = eng_full.handle([req])[0], eng_inc.handle([req])[0]
    assert res_inc.ranking == res_full.ranking
    np.testing.assert_allclose(res_inc.scores, res_full.scores, atol=1e-5)

    eng_inc.remove_images(["img5"])
    assert inc.n_valid == 11 and "img5" not in eng_inc.handle([req])[0].ranking
    with pytest.raises(ValueError, match="unknown reference"):
        eng_inc.handle([tserve.ServeRequest(caption="x", reference="img5")])
    eng_inc.add_images(["img_extra"], imgs[5:6])  # reuses the freed slot
    assert inc.capacity == 16 and inc.n_valid == 12
    assert inc.pos["img_extra"] == 5
    res = eng_inc.handle([req])[0]
    assert res.ranking == [n if n != "img5" else "img_extra"
                           for n in res_full.ranking]
    with pytest.raises(ValueError, match="already indexed"):
        eng_inc.add_images(["img0"], imgs[:1])
    inc.quantize()
    with pytest.raises(ValueError, match="immutable"):
        eng_inc.remove_images(["img0"])


def test_index_cache_round_trips_and_reads_jax_caches(index_data, tmp_path):
    import ml_dtypes

    d = dict(index_data)
    for key in ("raw1", "raw2"):  # caches hold bf16 banks
        d[key] = d[key].astype(ml_dtypes.bfloat16)
    jidx = jax_index(d)
    jidx.fingerprint = {"stage1": "abc", "split": "val"}
    tidx = tserve.ServingIndex(
        names=list(d["names"]), pooled_s1=torch.tensor(d["pooled"]),
        raw_s1=torch.tensor(index_data["raw1"]).to(torch.bfloat16),
        raw_s2=torch.tensor(index_data["raw2"]).to(torch.bfloat16),
        fingerprint={"stage1": "abc", "split": "val"})
    tidx.remove_rows(["im3"])  # compacted out of the cache
    live = [i for i in range(N) if i != 3]

    def bits(x):
        return x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x).view(np.int16)

    jidx.save(tmp_path / "jax.npz")
    tidx.save(tmp_path / "port.npz")
    for path, rows in (("jax.npz", list(range(N))), ("port.npz", live)):
        back = tserve.ServingIndex.load(
            tmp_path / path, expect_fingerprint={"stage1": "abc"},
            device="cpu")
        assert back.names == [d["names"][i] for i in rows]
        assert back.raw_s1.dtype == torch.bfloat16
        np.testing.assert_array_equal(back.pooled_s1.numpy(),
                                      d["pooled"][rows])
        np.testing.assert_array_equal(bits(back.raw_s1),
                                      bits(jidx.raw_s1)[rows])
        np.testing.assert_array_equal(bits(back.raw_s2),
                                      bits(jidx.raw_s2)[rows])
        assert back.fingerprint == {"stage1": "abc", "split": "val"}
    jback = jserve.ServingIndex.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(bits(jback.raw_s2), bits(jidx.raw_s2)[live])

    with pytest.raises(ValueError, match="does not match"):
        tserve.ServingIndex.load(tmp_path / "port.npz", device="cpu",
                                 expect_fingerprint={"stage1": "OTHER"})
    tidx.fingerprint = None
    tidx.save(tmp_path / "none.npz")
    with pytest.raises(ValueError, match="does not match"):
        tserve.ServingIndex.load(tmp_path / "none.npz", device="cpu",
                                 expect_fingerprint={"stage1": "abc"})
    tidx.quantize()
    with pytest.raises(ValueError, match="before quantize"):
        tidx.save(tmp_path / "int8.npz")


def test_params_fingerprint(models):
    *_, t1, t2 = models
    fp = tserve.params_fingerprint(t1.state_dict())
    n, size, _ = fp.split(":")
    assert int(n) == len(t1.state_dict())
    assert int(size) == sum(v.numel() for v in t1.state_dict().values())
    assert fp == tserve.params_fingerprint(t1.state_dict())
    assert fp != tserve.params_fingerprint(t2.state_dict())


def test_validation_messages_match_jax(models, tokenizers, index_data):
    jeng, teng = engines(models, tokenizers, jax_index(index_data),
                         port_index(index_data), False)
    bad = [dict(caption="", reference="im0"), dict(caption="x"),
           dict(caption="x", reference="nope.png"),
           dict(caption="x", reference="im0", k=0),
           dict(caption="x", reference="im0", k=N + 1)]
    for kw in bad:
        with pytest.raises(ValueError) as ref:
            jeng._validate(jserve.ServeRequest(**kw))
        with pytest.raises(ValueError) as out:
            teng.handle([tserve.ServeRequest(**kw)])
        assert str(out.value) == str(ref.value)


def _stage1_engine(models, tokenizers, index_data, q_pad=4):
    *_, t1, _ = models
    return tserve.CIRServingEngine(t1, None, tokenizers[1],
                                   port_index(index_data), text_len=TEXT_LEN,
                                   q_pad=q_pad, max_k=N, device="cpu")


def test_micro_batcher_concurrent_callers(models, tokenizers, index_data):
    """16 threads of 2 requests each, with a short switch interval: every
    caller gets what the engine gives its request alone, and the counters
    add up."""
    eng = _stage1_engine(models, tokenizers, index_data)
    reqs = [tserve.ServeRequest(caption=f"red {i % 5} dress",
                                reference=f"im{i % N}", k=1 + i % 8)
            for i in range(32)]
    alone = [eng.handle([r])[0] for r in reqs]
    batcher = tserve.MicroBatcher(eng, window_ms=20)
    results, interval = {}, sys.getswitchinterval()

    def call(t):
        for i in (2 * t, 2 * t + 1):
            results[i] = batcher.submit(reqs[i])

    threads = [threading.Thread(target=call, args=(t,)) for t in range(16)]
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        stats = batcher.stats()
        batcher.close()
    assert not any(t.is_alive() for t in threads)
    assert set(results) == set(range(32))
    for i, res in results.items():
        assert res.ranking == alone[i].ranking
        np.testing.assert_allclose(res.scores, alone[i].scores, atol=1e-6)
    assert stats["requests"] == 32 and stats["errors"] == 0
    assert 8 <= stats["waves"] <= 32
    assert stats["mean_wave_occupancy"] == round(32 / stats["waves"], 3)
    assert stats["latency_p99_s"] >= stats["latency_p50_s"] > 0
    assert not batcher.worker.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        batcher.submit(reqs[0])


def test_micro_batcher_isolates_bad_requests(models, tokenizers, index_data):
    eng = _stage1_engine(models, tokenizers, index_data)
    batcher = tserve.MicroBatcher(eng, window_ms=100)
    results, errors = {}, {}

    def call(i, ref):
        try:
            results[i] = batcher.submit(
                tserve.ServeRequest(caption=f"c {i}", reference=ref, k=3))
        except ValueError as e:
            errors[i] = str(e)

    threads = [threading.Thread(target=call, args=(i, ref)) for i, ref in
               enumerate(("im0", "does-not-exist", "im2"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stats = batcher.stats()
    batcher.close()
    assert set(results) == {0, 2} and set(errors) == {1}
    assert "unknown reference" in errors[1] and stats["errors"] == 1


def _post(port, path, obj, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _jpgs(directory, names, rng):
    import PIL.Image

    paths = []
    for name in names:
        path = directory / f"{name}.jpg"
        PIL.Image.fromarray(rng.integers(0, 255, size=(40, 36, 3),
                                         dtype=np.uint8)).save(path)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("enable_admin", [True, False])
def test_http_end_to_end(models, tokenizers, corpus, tmp_path, enable_admin):
    from candidate_reranking_cir_tpu_torch.cli.serve import make_http_server

    *_, t1, t2 = models
    names, imgs = corpus
    index = tserve.build_serving_index(
        t1, None, MemDataset(names[:8], imgs[:8]), reranker=t2,
        batch_size=4, device="cpu")
    eng = port_engine(models, tokenizers, index,
                      transform=make_transform("targetpad", IMG))
    eng.warmup()
    paths = _jpgs(tmp_path, ["new0", "new1"], np.random.default_rng(4))
    server = make_http_server(eng, 0, window_ms=5,
                              enable_admin=enable_admin)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert _get(port, "/healthz") == {"status": "ok", "corpus": 8}
        assert _get(port, "/statsz")["requests"] == 0
        code, out = _post(port, "/rank", {"caption": "a red hat",
                                          "reference": "img2", "k": 5})
        assert code == 200 and len(out["ranking"]) == 5
        assert "img2" not in out["ranking"] and out["reranked"] == 4
        ref = eng.handle([tserve.ServeRequest(caption="a red hat",
                                              reference="img2", k=5)])[0]
        assert out["ranking"] == ref.ranking
        code, out = _post(port, "/rank", {"caption": "uploaded",
                                          "reference_path": paths[0], "k": 3})
        assert code == 200 and out["reranked"] == 0
        assert len(out["ranking"]) == 3
        assert _post(port, "/rank", None, raw=b"{not json")[0] == 400
        assert _post(port, "/rank", {"caption": "x",
                                     "reference": "nope"})[0] == 400
        add = {"names": ["new0", "new1"], "paths": paths}
        code, out = _post(port, "/admin/add", add)
        if not enable_admin:
            assert code == 404
            return
        assert code == 200 and out == {"added": 2, "corpus": 10}
        code, out = _post(port, "/rank", {"caption": "x",
                                          "reference": "new1", "k": 9})
        assert code == 200 and "new1" not in out["ranking"]
        assert "new0" in out["ranking"]
        code, out = _post(port, "/admin/remove", {"names": ["new0"]})
        assert code == 200 and out == {"removed": 1, "corpus": 9}
        code, out = _post(port, "/rank", {"caption": "x",
                                          "reference": "new1", "k": 9})
        assert code == 200 and "new0" not in out["ranking"]
        assert _post(port, "/admin/remove", {"names": ["new0"]})[0] == 400
        assert _get(port, "/statsz")["errors"] == 1  # the unknown reference
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=10)


def test_cli_serve_stdio_matches_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs on one jpeg CIRR tree and the same reference-format
    checkpoints (fp32, the JAX side's Pallas kernels interpreted); the
    port's second run reads the index cache its first run wrote."""
    from candidate_reranking_cir_tpu.cli import serve as jcli
    from candidate_reranking_cir_tpu_torch.cli import serve as tcli
    from test_torch_port_cli import MODEL_CONFIG, TEXT_LEN as CLI_TEXT_LEN
    from test_torch_port_cli import make_workdir

    make_workdir(tmp_path, MODEL_CONFIG)
    image = tmp_path / "cirr_dataset" / "img" / "im7.jpg"
    lines = [{"caption": "a red dog", "reference": "im0", "k": 6},
             {"caption": "blue shirt with a cat", "reference": "im3",
              "k": 11},
             {"caption": "uploaded", "reference_path": str(image), "k": 4},
             {"caption": "x", "reference": "missing"},
             {"reference": "im1"}]
    stdin = "".join(json.dumps(x) + "\n" for x in lines)
    flags = ["--dataset", "CIRR", "--data-root", str(tmp_path),
             "--allow-test-vocab", "--image-size", str(IMG), "--text-len",
             str(CLI_TEXT_LEN), "--no-bf16", "--model-config",
             str(tmp_path / "model_config.json"), "--stage1-path",
             str(tmp_path / "s1.pt"), "--stage2-path",
             str(tmp_path / "s2.pt"), "--rerank-k", "4", "--q-pad", "2",
             "--batch-size", "4", "--mode", "stdio"]
    monkeypatch.setenv("CRC_NO_COMPILE_CACHE", "1")

    def run(main, extra):
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        main(flags + extra)
        out = capsys.readouterr().out.splitlines()
        return [json.loads(x) for x in out if x.startswith("{")]

    ref = run(jcli.main, ["--fused-attention", "on", "--mesh", "off"])
    cache = ["--index-cache", str(tmp_path / "index.npz"), "--device", "cpu"]
    outs = [run(tcli.main, cache), run(tcli.main, cache)]
    assert (tmp_path / "index.npz").exists()
    assert len(ref) == len(lines)
    for out in outs:
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            if "error" in r:
                assert o == r
                continue
            assert o["ranking"] == r["ranking"]
            assert o["reranked"] == r["reranked"]
            head = r["reranked"]
            np.testing.assert_allclose(o["scores"][:head], r["scores"][:head],
                                       atol=STAGE2_ATOL)
            np.testing.assert_allclose(o["scores"][head:], r["scores"][head:],
                                       atol=STAGE1_ATOL)
    assert [r.get("reranked") for r in ref] == [4, 4, 0, None, None]


def test_serving_entry_points_require_cuda_by_default(monkeypatch, tmp_path,
                                                      index_data):
    """Without a card, the serving entry points raise unless asked for the
    CPU; nothing moves to the CPU quietly."""
    from candidate_reranking_cir_tpu_torch.retrieval import rerank

    idx = port_index(index_data)
    idx.save(tmp_path / "idx.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.ServingIndex.load(tmp_path / "idx.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.build_serving_index(None, None, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.CIRServingEngine(None, None, None, idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        rerank.rerank(None, None, None, None, None, captions=[],
                      reference_names=[], topk_names=np.zeros((0, 1)),
                      index_feats=None, index_names=[], text_len=8)
    assert tserve.ServingIndex.load(tmp_path / "idx.npz",
                                    device="cpu").n_valid == N
