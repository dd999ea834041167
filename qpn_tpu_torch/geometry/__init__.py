from .poly import (Poly, PolyUnion, intersect, from_box, rand_poly,  # noqa: F401
                   random_polys_of_dim, union_intersect, lexico_positive,
                   get_lexico_ordering, HalfspaceLabel)
from .setops import (is_empty, is_empty_batch, contains, contains_batch,  # noqa: F401
                     issubset, issubset_pairs, issubset_union, support_batch,
                     implicit_bounds, intrinsic_dim, eliminate_variables,
                     remove_subsets, exemplar_batch, EmptySetError)
from .project import project, permute_columns, fourier_motzkin  # noqa: F401
from .vertices import get_verts, convex_hull  # noqa: F401

__all__ = [
    "Poly", "PolyUnion", "intersect", "from_box", "rand_poly",
    "random_polys_of_dim", "union_intersect", "lexico_positive",
    "get_lexico_ordering", "HalfspaceLabel",
    "is_empty", "is_empty_batch", "contains", "contains_batch", "issubset",
    "issubset_pairs", "issubset_union", "support_batch", "implicit_bounds",
    "intrinsic_dim", "eliminate_variables", "remove_subsets", "exemplar_batch",
    "EmptySetError", "project", "permute_columns", "fourier_motzkin",
    "get_verts", "convex_hull",
]
