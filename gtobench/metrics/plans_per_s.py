"""Plans returned a second: every plan of every solve issued in the window,
over the time from the window's start to the last completion (host clock)."""


def read(run):
    return run.window.rate if run.units == "plans" else None
