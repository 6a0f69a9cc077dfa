"""tokens_per_s: every token trained in the window over the window's wall
time (host clock, from a step boundary to the synchronize after the last
step started inside --seconds)."""


def read(rec):
    w = rec["window"]
    return w["steps"] * w["tokens_per_step"] / w["seconds"]
