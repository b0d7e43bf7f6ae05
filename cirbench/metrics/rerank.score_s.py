"""Mean over the window's calls of the re-rank engine's own spans
``seconds['zt'] + seconds['score']`` (stage-I fusion for z_t, then the
candidate-major scheduler and the dual encoder), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["zt"] + c["seconds"]["score"]
             for c in run["calls"] if "zt" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
