"""setup_s: seconds from process start to the first timed frame."""


def read(window):
    return window.get("setup_s")
