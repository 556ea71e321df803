"""Seconds of audio whose transcript or alignment completed in the window,
over the window's seconds."""


def read(run):
    return sum(r.seconds for r in run.window.done) / run.window.seconds
