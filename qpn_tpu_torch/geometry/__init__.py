from .poly import (Poly, PolyUnion, intersect, from_box, rand_poly,  # noqa: F401
                   random_polys_of_dim, HalfspaceLabel)
