"""Mean over the window's calls of the index build's staging on the host,
the phase spans ``seconds['index.load'] + seconds['index.upload']`` (each
batch's assembly, and its copy to the card), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["index.load"] + c["seconds"]["index.upload"]
             for c in run["calls"] if "index.load" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
