"""setup_s (s, host clock): from the process's start to the first timed
call: imports, the kernels' build or load, the model's assembly, the pool
drawn and placed on the card, one call on every ensemble of the pool."""


def read(rec):
    return rec.setup_s
