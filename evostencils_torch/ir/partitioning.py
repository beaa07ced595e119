"""Smoother sweep partitionings (reference ir/partitioning.py:1-47).

`Single` — one full sweep (Jacobi-type, all points simultaneously).
`RedBlack` — two half-sweeps over the checkerboard colors; the second
color sees the updates of the first (Gauss–Seidel-type coupling that is
still fully data-parallel within each color — ideal for the TPU VPU,
realized as masked full-grid updates in ops/smoothers.py).
"""

from evostencils_torch.stencils import constant, periodic


class Partitioning:
    pass


class Single(Partitioning):
    @staticmethod
    def generate(stencil, grid):
        if stencil is None:
            return [None]
        return [constant.get_unit_stencil(grid)]

    @staticmethod
    def get_name():
        return "single"

    def __repr__(self):
        return "Single()"


class RedBlack(Partitioning):
    @staticmethod
    def generate(stencil, grid):
        if stencil is None:
            return [None]
        return periodic.red_black_partitioning(stencil, grid)

    @staticmethod
    def get_name():
        return "red_black"

    def __repr__(self):
        return "RedBlack()"
