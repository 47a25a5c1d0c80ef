"""Reconstructions returned to the host over the window's seconds."""


def read(run):
    n = run["units"].get("recon")
    return None if n is None else n / run["window_s"]
