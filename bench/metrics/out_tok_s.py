"""Generated tokens delivered inside the window over its seconds."""


def read(r):
    return r.records["tokens"] / r.window_s if r.records.get("tokens") \
        else None
