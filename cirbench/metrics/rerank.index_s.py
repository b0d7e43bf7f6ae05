"""Mean over the window's calls of the engine's own span
Stage2Result.seconds['index'] (the stage-II ViT bank of the corpus), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["index"] for c in run["calls"]
             if "index" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
