"""setup_s: seconds from the process's start to the first timed step."""


def read(rec):
    return rec["setup_s"]
