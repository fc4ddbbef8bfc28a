"""peak_gib: torch.cuda.max_memory_allocated over the window, read call
by call, less the bytes of the outputs that the check keeps, in GiB:
what the program holds."""


def read(rec):
    if not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 2 ** 30
