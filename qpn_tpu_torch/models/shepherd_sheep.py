"""Shepherd and sheep (behavioral port of the deprecated
examples/deprecated/shepherd_sheep.jl idea): the shepherd places a feed bucket;
the sheep moves toward the bucket but stays in its pen; the shepherd wants the
sheep at a target spot while keeping the bucket close to the barn.

Classic bilevel with a box-constrained follower whose solution map has corner
pieces — a compact exercise of the solution-graph machinery with 2-D pieces.
"""

from __future__ import annotations

import numpy as np

from ..frontend import QPNetBuilder, variables, dot
from . import register


@register("shepherd_sheep")
def setup(pen: float = 1.0, bucket_range: float = 3.0,
          target=(0.8, 0.8), barn=(-2.0, 0.0), barn_weight: float = 0.1,
          **kwargs):
    bkt = variables("bkt", 2)     # shepherd's bucket position
    shp = variables("shp", 2)     # sheep position
    b = QPNetBuilder(bkt, shp)

    # sheep: walk to the bucket, constrained to the pen box
    cid_s = b.add_constraint([shp[0], shp[1]],
                             np.full(2, -pen), np.full(2, pen))
    d_s = [shp[0] - bkt[0], shp[1] - bkt[1]]
    sheep = b.add_qp(dot(d_s, d_s), [cid_s], shp)

    # shepherd: sheep at target; bucket near the barn
    cid_b = b.add_constraint([bkt[0], bkt[1]],
                             np.full(2, -bucket_range),
                             np.full(2, bucket_range))
    d_t = [shp[0] - float(target[0]), shp[1] - float(target[1])]
    d_b = [bkt[0] - float(barn[0]), bkt[1] - float(barn[1])]
    shepherd = b.add_qp(dot(d_t, d_t) + barn_weight * dot(d_b, d_b),
                        [cid_b], bkt)

    b.add_edges([(shepherd, sheep)])
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    b.net.default_initialization = np.zeros(4)
    b.net.problem_data.update(pen=pen, target=np.asarray(target),
                              barn=np.asarray(barn))
    return b.net
