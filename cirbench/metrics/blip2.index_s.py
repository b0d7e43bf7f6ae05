"""Mean over the window's calls of the BLIP-2 evaluation's layer span
``seconds['index']`` (the ViT-g and ``ln_vision`` over the corpus, its
staging included), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["index"] for c in run["calls"]
             if "index" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
