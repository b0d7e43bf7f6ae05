"""Mean over the window's calls of the candidate-major scheduler's
planning on the host, the phase span ``seconds['rerank.plan']`` (pair lists
per candidate, chunking, packing and the packed arrays' uploads, inside
the ``score`` span), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["rerank.plan"] for c in run["calls"]
             if "rerank.plan" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
