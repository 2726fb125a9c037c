"""Seconds from the process's start to the first step of the window:
imports, CUDA start, kernel loads, the encoder, the programme and the two
warm-up rounds."""


def read(run):
    return run["setup_s"]
