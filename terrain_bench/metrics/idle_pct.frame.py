"""The share of the traced frames' wall time in which no device operation
ran: one minus the union of the device records between the first read
frame's marker and the marker after the last, over that span, in percent."""


def read(t):
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
