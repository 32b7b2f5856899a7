"""normal_eq_ms: device ms of one build of the normal equations at the
start problem (`normal_equations`), median of CUDA-event spans."""


def read(record):
    return record.get("spans", {}).get("normal_eq")
