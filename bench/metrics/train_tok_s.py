"""Training tokens of the steps that finished inside the window over its
seconds."""


def read(r):
    return r.records["train_tokens"] / r.window_s \
        if r.records.get("train_tokens") else None
