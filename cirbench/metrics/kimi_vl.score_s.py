"""Mean over the window's calls of the prefix scorer's layer span
``seconds['score']`` (every chunk's suffix pass over its queries' top-K and
group candidates against the kept latents, to logit(yes) - logit(no); each
chunk's span ends in a device sync), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["score"] for c in run["calls"]
             if "score" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
