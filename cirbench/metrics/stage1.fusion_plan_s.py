"""Mean over the window's calls of the fusion scheduler's planning on the
host, the phase span ``seconds['fusion.plan']`` (tokenize, buckets and the
schedule of fusion batches), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["fusion.plan"] for c in run["calls"]
             if "fusion.plan" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
