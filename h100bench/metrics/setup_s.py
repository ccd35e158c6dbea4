"""Set-up seconds: from the harness's start to the window's, the trainer built
and loaded, the feed's cache filled, the first executions run (and at
K > 1 the CUDA graph captured)."""


def read(rec):
    return rec["setup_s"]
