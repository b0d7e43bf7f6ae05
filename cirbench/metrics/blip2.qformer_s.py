"""Mean over the window's calls of the BLIP-2 evaluation's Q-Former work,
the layer spans ``seconds['targets'] + seconds['fusion']`` (the query pass
and ``vision_proj`` over every corpus image, then the image-major fusion
of every caption with its plan), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["targets"] + c["seconds"]["fusion"]
             for c in run["calls"] if "targets" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
