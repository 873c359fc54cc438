"""Seconds from the process's start to the window's opening."""


def read(r):
    return r.setup_s
