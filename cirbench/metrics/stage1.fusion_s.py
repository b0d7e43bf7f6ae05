"""Mean over the window's calls of the engine's own span
Stage1EvalResult.seconds['fusion'] (the fusion scheduler and the MED), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["fusion"] for c in run["calls"]
             if "fusion" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
