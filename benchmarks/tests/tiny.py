"""A cell cut to a size a CPU test holds: the trainer's own bert-tiny
preset (models/transformer.py TINY), 4 rows of 32 tokens, the cell's
limits, optimizer and everything else as its files give them, but for
loss_gap: a tiny batch's loss is the mean over some 20 masked positions,
not some 10000, and its bfloat16 gap to the reference is 5-8 times the
cell's (1.1e-4 to 1.4e-4 against 1.7e-5 to 2.2e-5), so it is printed and
not compared here."""

from __future__ import annotations

from benchmarks import cells

SEQ, BATCH = 32, 4


def tiny_cell(name: str) -> dict:
    cell = cells.load(name)
    cell["arch"].update(layers=2, hidden=128, heads=4, vocab=1024,
                        max_len=max(SEQ, cell["cfg"].get("min_positions", 1)))
    cell["shape"].update(cell["arch"], seq=SEQ, batch=BATCH, reference_rows=2)
    rest = cell["argv"][cell["argv"].index("--moment-dtype"):]
    rest[rest.index("--seq") + 1] = str(SEQ)
    rest[rest.index("--batch") + 1] = str(BATCH)
    cell["argv"] = ["--model", "bert-tiny"] + rest
    cell["warmup_steps"] = 1
    cell["limits"] = dict(cell["limits"], loss_gap=None)
    return cell
