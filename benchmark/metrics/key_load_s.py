"""Seconds of ``protocol/keys.py:load_dir``, ending in a device sync."""


def read(run):
    return run.key_load_s
