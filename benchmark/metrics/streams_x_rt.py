"""Station-seconds of audio whose bytes the window's drains emitted, over
the window's wall seconds: the card's capacity in live stations."""


def read(run):
    t0, t1 = run["window"]
    return len(run["steps"]) * run["S"] * run["audio_s"] / (t1 - t0)
