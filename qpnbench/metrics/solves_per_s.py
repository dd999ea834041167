"""solves_per_s (lanes/s, host clock): lanes the program certified in the
measured window over the whole window's time."""


def read(rec):
    return rec.certified / rec.window_s
