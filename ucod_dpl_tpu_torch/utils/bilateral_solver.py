"""Fast bilateral solver for mask refinement (TokenCut-style), jax-free.

The port's copy of :mod:`ucod_dpl_tpu.utils.bilateral_solver` (numpy and
scipy only).  Behavioral counterpart of ``engine/utils/bilateral_solver.py`` +
``engine/utils/misc.py:62-156``: a 5-D XYLUV bilateral grid, bistochastic
normalisation, Jacobi-preconditioned conjugate gradient solve, and the
IoU>0.5 acceptance gate used to decide whether the refined mask replaces the
original.  Host-side (scipy.sparse) by design: the solve is a small sparse
CG over ~10^4 grid vertices, latency-bound, and runs rarely (optional
post-processing) — device offload would be all transfer overhead.

Implementation is original; the algorithm follows Barron & Poole, "The Fast
Bilateral Solver" (ECCV 2016).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.sparse import csr_matrix, diags
from scipy.sparse.linalg import cg

RGB_TO_YUV = np.array(
    [[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5], [0.5, -0.418688, -0.081312]]
)
YUV_OFFSET = np.array([0.0, 128.0, 128.0])
MAX_VAL = 255.0


DEFAULT_GRID_PARAMS = {"sigma_luma": 4, "sigma_chroma": 4, "sigma_spatial": 24}
DEFAULT_BS_PARAMS = {"lam": 256, "A_diag_min": 1e-5, "cg_tol": 1e-5, "cg_maxiter": 25}


class BilateralGrid:
    """Splat/blur/slice operators over a 5-D (x, y, luma, u, v) grid."""

    def __init__(self, image: np.ndarray, sigma_spatial=32, sigma_luma=8, sigma_chroma=8):
        im_yuv = image.astype(np.float64) @ RGB_TO_YUV.T + YUV_OFFSET
        h, w = image.shape[:2]
        ii, jj = np.mgrid[:h, :w]
        coords = np.concatenate(
            [
                (ii[:, :, None] / sigma_spatial),
                (jj[:, :, None] / sigma_spatial),
                (im_yuv[:, :, :1] / sigma_luma),
                (im_yuv[:, :, 1:] / sigma_chroma),
            ],
            axis=2,
        ).astype(int)
        coords_flat = coords.reshape(-1, coords.shape[-1])
        self.npixels = coords_flat.shape[0]
        self.dim = coords_flat.shape[1]

        # hash coordinates to unique vertex ids
        _, unique_inv = np.unique(
            coords_flat.view([("", coords_flat.dtype)] * self.dim),
            return_inverse=True,
        )
        self.nvertices = int(unique_inv.max()) + 1
        self._splat = csr_matrix(
            (np.ones(self.npixels), (unique_inv.ravel(), np.arange(self.npixels))),
            shape=(self.nvertices, self.npixels),
        )
        # blur: sum of +-1 shifts along each grid dim over occupied vertices
        self._coords_unique = np.zeros((self.nvertices, self.dim), dtype=int)
        self._coords_unique[unique_inv.ravel()] = coords_flat
        self._build_blur()

    def _build_blur(self) -> None:
        lookup = {tuple(c): i for i, c in enumerate(self._coords_unique)}
        rows, cols = [], []
        for d in range(self.dim):
            for off in (-1, 1):
                neighbor = self._coords_unique.copy()
                neighbor[:, d] += off
                for i, c in enumerate(neighbor):
                    j = lookup.get(tuple(c))
                    if j is not None:
                        rows.append(i)
                        cols.append(j)
        data = np.ones(len(rows))
        off_diag = csr_matrix(
            (data, (rows, cols)), shape=(self.nvertices, self.nvertices)
        )
        self._blur = 2 * self.dim * diags(np.ones(self.nvertices)) + off_diag

    def splat(self, x: np.ndarray) -> np.ndarray:
        return self._splat @ x

    def slice(self, y: np.ndarray) -> np.ndarray:
        return self._splat.T @ y

    def blur(self, x: np.ndarray) -> np.ndarray:
        return self._blur @ x

    def filter(self, x: np.ndarray) -> np.ndarray:
        return self.slice(self.blur(self.splat(x))) / self.slice(
            self.blur(self.splat(np.ones_like(x)))
        )


def _bistochastize(grid: BilateralGrid, maxiter: int = 10):
    """Compute diagonal matrices Dn, Dm making splat/blur bistochastic."""
    m = grid.splat(np.ones(grid.npixels))
    n = np.ones(grid.nvertices)
    for _ in range(maxiter):
        n = np.sqrt(n * m / np.maximum(grid.blur(n), 1e-20))
    # correct m so Dm is consistent with the (finitely) iterated n regardless
    # of convergence — the reference does this too (bilateral_solver.py:114-117)
    # and A_smooth = Dm - Dn B Dn differs measurably without it
    m = n * grid.blur(n)
    Dm = diags(m)
    Dn = diags(n)
    return Dn, Dm


class BilateralSolver:
    def __init__(self, grid: BilateralGrid, params: Dict = None):
        self.grid = grid
        self.params = {**DEFAULT_BS_PARAMS, **(params or {})}
        self.Dn, self.Dm = _bistochastize(grid)

    def solve(self, target: np.ndarray, confidence: np.ndarray) -> np.ndarray:
        """Minimise the bilateral-smoothness + confidence-weighted data term."""
        lam = self.params["lam"]
        grid = self.grid
        A_smooth = self.Dm - self.Dn @ grid._blur @ self.Dn
        w = confidence.reshape(-1, 1)
        t = target.reshape(-1, 1)
        A_data = diags(grid.splat(w.ravel()))
        A = lam * A_smooth + A_data
        b = grid.splat((w * t).ravel())
        # Jacobi preconditioner
        A_diag = np.maximum(A.diagonal(), self.params["A_diag_min"])
        M = diags(1.0 / A_diag)
        y0 = grid.splat((w * t).ravel()) / np.maximum(grid.splat(w.ravel()), 1e-10)
        y, _ = cg(
            A,
            b,
            x0=y0,
            M=M,
            rtol=self.params["cg_tol"],
            maxiter=self.params["cg_maxiter"],
        )
        return grid.slice(y).reshape(target.shape)


def _mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter / union) if union else 0.0


def bilateral_solver_output(
    image: np.ndarray,
    target: np.ndarray,
    sigma_spatial: int = 24,
    sigma_luma: int = 4,
    sigma_chroma: int = 4,
    get_all_cc: bool = False,
    bs_params: Dict = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(soft_solution, binary_mask) — the reference's ``bilateral_solver_output``
    (``engine/utils/bilateral_solver.py:159-214``): solve, fill holes of the
    >0.5 binarisation, then keep the second-largest connected component (the
    largest is background) — or, with ``get_all_cc``, all components except
    the largest."""
    from scipy import ndimage

    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    target = np.squeeze(np.asarray(target, dtype=np.float64))
    if target.ndim != 2:
        raise ValueError(f"target must be (H, W) or (H, W, 1); got {target.shape}")
    h, w = target.shape

    grid = BilateralGrid(
        image,
        sigma_spatial=sigma_spatial,
        sigma_luma=sigma_luma,
        sigma_chroma=sigma_chroma,
    )
    solver = BilateralSolver(grid, bs_params)
    soft = solver.solve(target, np.full_like(target, 0.999))

    filled = ndimage.binary_fill_holes(soft > 0.5)
    labeled, nr_objects = ndimage.label(filled)
    nb_pixel = [np.sum(labeled == i) for i in range(nr_objects + 1)]
    pixel_order = np.argsort(nb_pixel)
    if get_all_cc:
        descending = pixel_order[::-1]
        binary = (
            (labeled[None, :, :] == descending[1:, None, None]).astype(int).sum(0)
        )
    else:
        if len(pixel_order) >= 2:
            binary = labeled == pixel_order[-2]
        else:
            binary = np.ones((h, w), dtype=bool)
    return soft, binary


def apply_bilateral_solver(
    mask: np.ndarray,
    image: np.ndarray,
    iou_threshold: float = 0.5,
    grid_params: Dict = None,
    bs_params: Dict = None,
    get_all_cc: bool = False,
) -> Tuple[np.ndarray, bool]:
    """Refine a soft/binary mask against image edges.

    Returns (refined_binary_mask, accepted): the refinement is *accepted*
    only when the IoU between the connected-component-selected solver output
    and the input exceeds ``iou_threshold`` — the reference's
    ``bs_iou_threshold`` gate (misc.py:110-156; both masks binarise at the
    protocol-fixed 0.5 inside its IoU).  Callers keep the original mask when
    rejected.
    """
    gp = {**DEFAULT_GRID_PARAMS, **(grid_params or {})}
    # squeeze (H, W, 1) pipeline masks: the IoU below would otherwise
    # broadcast (H, W, 1) against the solver's (H, W) into (H, W, W)
    mask = np.squeeze(np.asarray(mask, dtype=np.float64))
    _, binary = bilateral_solver_output(
        image,
        mask,
        sigma_spatial=gp["sigma_spatial"],
        sigma_luma=gp["sigma_luma"],
        sigma_chroma=gp["sigma_chroma"],
        get_all_cc=get_all_cc,
        bs_params=bs_params,
    )
    accepted = _mask_iou(binary > 0.5, mask > 0.5) > iou_threshold
    return (binary > 0.5).astype(np.float32), accepted


def bbox_iou(box_a, box_b) -> float:
    """IoU of (x0, y0, x1, y1) boxes (counterpart of misc.bbox_iou:193-253)."""
    ax0, ay0, ax1, ay1 = box_a
    bx0, by0, bx1, by1 = box_b
    ix0, iy0 = max(ax0, bx0), max(ay0, by0)
    ix1, iy1 = min(ax1, bx1), min(ay1, by1)
    iw, ih = max(0, ix1 - ix0 + 1), max(0, iy1 - iy0 + 1)
    inter = iw * ih
    area_a = (ax1 - ax0 + 1) * (ay1 - ay0 + 1)
    area_b = (bx1 - bx0 + 1) * (by1 - by0 + 1)
    union = area_a + area_b - inter
    return inter / union if union else 0.0


def batch_apply_bilateral_solver(masks, images, iou_threshold: float = 0.5):
    """Refine a batch of masks, keeping originals where the IoU gate rejects
    (counterpart of misc.batch_apply_bilateral_solver:71-107)."""
    out = []
    for mask, image in zip(masks, images):
        refined, accepted = apply_bilateral_solver(
            mask, image, iou_threshold=iou_threshold
        )
        out.append(refined if accepted else np.asarray(mask, np.float32))
    return out


def bbox_from_mask(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1) of the largest connected component (counterpart of
    get_bbox_from_segmentation_labels, misc.py:158-190)."""
    from ucod_dpl_tpu_torch.utils.components import connected_components

    num, labels = connected_components(mask)
    if num == 0:
        h, w = mask.shape
        return 0, 0, w - 1, h - 1
    areas = [(labels == i).sum() for i in range(1, num + 1)]
    comp = labels == (int(np.argmax(areas)) + 1)
    ys, xs = np.nonzero(comp)
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())
