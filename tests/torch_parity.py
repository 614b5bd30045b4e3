"""Shared inputs for the parity tests of the PyTorch/CUDA build
(``tests/test_torch_*.py``): numpy problems made from a seed and handed to
both packages, and the bridge that turns an ``nmf_tpu`` store into the dict
of numpy arrays that ``nmf_tpu_torch.convert`` takes."""

import dataclasses

import numpy as np

# thresholds that put the three density regions of ``three_class_matrix``
# into the dense store, the chunk store and the COO band
DENSE_NNZ = 1000
COO_NNZ = 40
BUILD = dict(stripe_tiles=2, group=8, dense_tile_nnz=DENSE_NNZ,
             coo_tail_nnz=COO_NNZ)

_TOP_ARRAYS = ("row_idx", "col_idx", "values", "row_perm", "row_rank",
               "col_perm", "col_rank", "stats")


def three_class_matrix(seed=0, p=300, n=260):
    """Dense float32 matrix whose 128x128 tiles fall into all three store
    classes: a dense head (top-left tiles, ~30% full), a body (~3% full)
    and a dusty last row/column panel (~0.1% full)."""
    rng = np.random.default_rng(seed)
    dens = np.full((p, n), 0.03)
    dens[:128, :] = 0.3
    dens[:, :128] = np.maximum(dens[:, :128], 0.3)
    dens[256:, :] = 0.001
    dens[:, 256:] = 0.001
    Xd = (rng.random((p, n)) + 0.5) * (rng.random((p, n)) < dens)
    return Xd.astype(np.float32)


def coo_of(Xd):
    r, c = np.nonzero(Xd)
    return r, c, Xd[r, c]


def jax_tiled_to_dict(X):
    """Fields of an ``nmf_tpu`` TiledCSR as numpy arrays and ints."""

    def side(s):
        out = {}
        for f in dataclasses.fields(s):
            v = getattr(s, f.name)
            out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
        return out

    d = {
        name: None if getattr(X, name) is None else np.asarray(getattr(X, name))
        for name in _TOP_ARRAYS
    }
    d.update(fwd=side(X.fwd), bwd=side(X.bwd), shape=tuple(X.shape),
             build_opts=X.build_opts)
    return d


QUAD_DENSE_NNZ = 1000
# build options that put ``four_class_matrix`` into all four store classes
QUAD_BUILD = dict(stripe_tiles=2, group=8, dense_tile_nnz=QUAD_DENSE_NNZ,
                  quad_tail_nnz=32, coo_tail_nnz=2)


def four_class_matrix(seed=0, p=700, n=530):
    """Dense float32 matrix for the quad-tail store: a dense head (first row
    and column panel, ~30% full), a body of ~3% (plain chunks), and a tail of
    ~0.07% (about 11 nonzeros a tile: quad tiles, a few of them with at most
    2 nonzeros).  With ``stripe_tiles=2`` in natural order the first stripe
    (rows 0-255) holds no quad tile; the last row panel (60 rows) and the
    last column panel (18 columns) are cut."""
    rng = np.random.default_rng(seed)
    dens = np.full((p, n), 0.0007)
    dens[:256, :] = 0.03
    dens[:128, :] = 0.3
    dens[:, :128] = np.maximum(dens[:, :128], 0.3)
    dens[256:384, 128:256] = 0.03
    Xd = (rng.random((p, n)) + 0.5) * (rng.random((p, n)) < dens)
    return Xd.astype(np.float32)


# builds of ``four_class_matrix`` for the product tests
QUAD_CASES = {
    # all four classes; in natural order the first stripe holds no quad tile
    # and the last row and column panels are cut
    "four_classes_degree": dict(QUAD_BUILD, order="degree"),
    "four_classes_natural": dict(QUAD_BUILD, order="natural"),
    "seg16_natural": dict(QUAD_BUILD, quad_seg=16, quad_tail_nnz=16, order="natural"),
    "seg16_degree": dict(QUAD_BUILD, quad_seg=16, quad_tail_nnz=12, order="degree"),
    "quad_and_chunks": dict(stripe_tiles=2, group=8, quad_tail_nnz=32),
    "one_stripe_full_chunks": dict(stripe_tiles=32, group=16, quad_tail_nnz=32,
                                   dense_tile_nnz=1000),
    "span2": dict(stripe_tiles=2, group=8, tail_span=2, order="natural"),
    "span4_dense_band": dict(stripe_tiles=2, group=8, tail_span=4,
                             dense_tile_nnz=1000, coo_tail_nnz=2),
}
