"""device_idle_pct.clip: the share of the window that no chunk's
interval on the card covers (each chunk's interval runs from the event
recorded before its call to the event recorded after it).  Layer:
device.  Moves frames_per_s: a card that waits on the host completes
fewer frames."""


def read(run):
    if not run.chunk_device_ms():
        return None
    s = run.win.seconds
    return 100.0 * (1.0 - run.covered_s(0.0, s) / s)
