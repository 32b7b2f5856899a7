"""setup_s: seconds from the harness's start to the end of the warm solve
(imports, CUDA context, the problem generated on the card, one solve)."""


def read(record):
    return record.get("setup_s")
