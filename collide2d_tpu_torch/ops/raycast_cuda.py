"""Scene raycast: kernel 11 and its plain version.

Counterpart of ``collide2d_tpu/ops/raycast_pallas.py``. The scene becomes
one half-plane table (`pack_scene_tables`): for each shape and face the
UNIT outward normal and its offset, as the Pallas wrapper builds them
(``un = n / where(|n| > 0, |n|, 1)``, ``off = un . p``), and the shape's
any-face flag. Ratios are scale-invariant, so the unit table gives the same
windows as `ops.raycast`'s unnormalised one up to float32 rounding, and the
entry normal comes out of the table already unit.

- `scene_raycast_plain` is the kernel's arithmetic in torch operations:
  per face ``no = nx*ox + ny*oy``, ``nd = nx*dx + ny*dy``, ``num = off -
  no``, ``ratio = num / where(nd == 0, 1, nd)``, the parallel cases, the
  entry on strict ``>`` (the first face wins, carrying its normal), the
  exit a min; per shape the hit test; over shapes the first-index argmin.
  It runs in chunks of rays (each ray is independent, so chunking is
  bitwise) so that no (rays, shapes) intermediate outgrows ``max_elems``.
- `scene_raycast_cuda_t` routes on the device of its inputs: a CUDA tensor
  launches ``csrc/raycast_kernel.cu`` (built at first use by
  `utils.cuda_build`, one library per face count 4, 8 and 16 and a generic
  one for other multiples of 4: `raycast_defines`) and counts the launch in
  ``LAUNCHES``; a failed build or launch, or an input it does not take,
  raises; a CPU tensor runs the plain version. Inputs that require grad
  raise (no backward; the differentiable path is
  ``scene_raycast(impl='torch')``).
- `scene_raycast_faces` launches the library built to count the (ray,
  face) pairs the kernel evaluates (its early exit skips the rest).
"""

from __future__ import annotations

import ctypes

import torch

from collide2d_tpu_torch.ops.distance_cuda import refuse_grad
from collide2d_tpu_torch.ops.geometry import edge_normals
from collide2d_tpu_torch.ops.sat import _normalize_padding
from collide2d_tpu_torch.utils import cuda_build

_KERNEL = "raycast_kernel"
_INF = float("inf")
FACE_ALIGN = 4  # the table pads each shape's faces to a multiple of this
MAX_FACES = 3072  # faces of one shape the kernel's 48 KB tile holds
MAX_ELEMS = 1 << 22  # the plain version's largest (rays, shapes) block
SPECIALISED_KP = (4, 8, 16)  # face counts with a library of their own
# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def pack_scene_tables(polys: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """(N, k, 2) shapes [+ (N, k) mask] -> the (N, KP, 4) float32 table
    [nx, ny, off, any-face] on the shapes' device, KP = k rounded up to
    `FACE_ALIGN`. A padding face is all zero: ``0 <= 0``, never clips and
    never enters (the same as a zero-length edge)."""
    p = _normalize_padding(torch.as_tensor(polys, dtype=torch.float32), mask)
    if p.dim() != 3 or p.shape[-1] != 2 or p.shape[1] < 1:
        raise ValueError(f"polys must be (N, k, 2) with k >= 1, got {tuple(p.shape)}")
    n = edge_normals(p)  # (N, k, 2), outward, unnormalised
    nx, ny = n[..., 0], n[..., 1]
    ln = torch.sqrt(nx * nx + ny * ny)
    d = torch.where(ln > 0, ln, 1.0)
    ux, uy = nx / d, ny / d
    off = ux * p[..., 0] + uy * p[..., 1]
    anyf = (ln > 0).any(dim=-1, keepdim=True).to(torch.float32).expand_as(off)
    table = torch.stack([ux, uy, off, anyf], dim=-1)
    k = p.shape[1]
    kp = -(-k // FACE_ALIGN) * FACE_ALIGN
    if kp != k:
        table = torch.cat([table, table.new_zeros((p.shape[0], kp - k, 4))], dim=1)
    return table.contiguous()


def _raycast_rows(ox, oy, dx, dy, table, t_max):
    """Kernel 11 on a (C,) chunk of rays against the whole table: (t, index,
    nx, ny), each (C,)."""
    nshape = table.shape[0]
    shape2 = (ox.shape[0], nshape)
    entry = torch.full(shape2, -_INF, dtype=torch.float32, device=ox.device)
    exit_ = torch.full(shape2, _INF, dtype=torch.float32, device=ox.device)
    bnx = torch.zeros(shape2, dtype=torch.float32, device=ox.device)
    bny = torch.zeros_like(bnx)
    ox, oy, dx, dy = ox[:, None], oy[:, None], dx[:, None], dy[:, None]
    for j in range(table.shape[1]):
        nx, ny, off = table[:, j, 0], table[:, j, 1], table[:, j, 2]
        no = nx * ox + ny * oy  # (C, N)
        nd = nx * dx + ny * dy
        num = off - no  # constraint: t * nd <= num
        ratio = num / torch.where(nd == 0, 1.0, nd)
        pm = (nd == 0) & (num < 0)  # parallel face, origin outside
        lo = torch.where(nd < 0, ratio, torch.where(pm, _INF, -_INF))
        hi = torch.where(nd > 0, ratio, torch.where(pm, -_INF, _INF))
        upd = lo > entry  # strict: the first max wins
        entry = torch.where(upd, lo, entry)
        bnx = torch.where(upd, nx, bnx)
        bny = torch.where(upd, ny, bny)
        exit_ = torch.minimum(exit_, hi)
    anyf = table[:, 0, 3] > 0
    hit = (entry <= exit_) & (entry <= t_max) & (exit_ >= 0) & anyf
    inside = hit & (entry < 0)
    t_all = torch.where(hit, torch.clamp(entry, min=0.0), _INF)
    keep_n = hit & ~inside
    bnx = torch.where(keep_n, bnx, 0.0)
    bny = torch.where(keep_n, bny, 0.0)
    # first index at the minimum: ties and all-miss rays take the smallest
    idx = t_all.argmin(dim=-1, keepdim=True)
    return (torch.gather(t_all, 1, idx)[:, 0], idx[:, 0],
            torch.gather(bnx, 1, idx)[:, 0], torch.gather(bny, 1, idx)[:, 0])


def scene_raycast_plain(origin: torch.Tensor, direction: torch.Tensor,
                        table: torch.Tensor, *, t_max: float = _INF,
                        chunk: int | None = None):
    """Kernel 11 in torch operations: (R, 2) rays against a
    `pack_scene_tables` table -> ``(t (R,), index (R,) int32, normal (R,
    2))``, in chunks of ``chunk`` rays (default: the most that keep a (rays,
    shapes) block within `MAX_ELEMS` elements)."""
    r = origin.shape[0]
    if chunk is None:
        chunk = max(1, MAX_ELEMS // max(table.shape[0], 1))
    outs = []
    for s in range(0, r, chunk):
        o, d = origin[s:s + chunk], direction[s:s + chunk]
        outs.append(_raycast_rows(o[:, 0], o[:, 1], d[:, 0], d[:, 1], table,
                                  float(t_max)))
    if not outs:
        z = origin.new_zeros((0,))
        return z, z.to(torch.int32), origin.new_zeros((0, 2))
    t, idx, nx, ny = (torch.cat(parts) for parts in zip(*outs))
    return t, idx.to(torch.int32), torch.stack([nx, ny], dim=-1)


def _check(origin: torch.Tensor, direction: torch.Tensor, table: torch.Tensor) -> None:
    refuse_grad(origin, direction, table)
    for name, x in (("origin", origin), ("direction", direction), ("table", table)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if origin.dim() != 2 or origin.shape[1] != 2 or direction.shape != origin.shape:
        raise ValueError(f"origin and direction must be (R, 2), got "
                         f"{tuple(origin.shape)} and {tuple(direction.shape)}")
    if (table.dim() != 3 or table.shape[2] != 4 or table.shape[0] < 1
            or table.shape[1] < 1 or table.shape[1] % FACE_ALIGN):
        raise ValueError(f"table must be (N, KP, 4) with KP a multiple of "
                         f"{FACE_ALIGN}, got {tuple(table.shape)}")
    if not (origin.device == direction.device == table.device):
        raise ValueError(f"inputs on {origin.device}, {direction.device} and "
                         f"{table.device}")
    if origin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {origin.device}")


def raycast_defines(kp: int, count_faces: bool = False) -> tuple[tuple[str, int], ...]:
    """The ``-D`` defines of kernel 11's library for tables of ``kp`` faces a
    shape: its own face count where it has one (`SPECIALISED_KP`), else the
    generic form; ``count_faces`` builds the variant that counts the (ray,
    face) pairs it evaluates (`scene_raycast_faces`)."""
    defs = (("RAYCAST_KP", int(kp)),) if int(kp) in SPECIALISED_KP else ()
    return defs + ((("RAYCAST_COUNT_FACES", 1),) if count_faces else ())


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launch functions' C signatures on a loaded library (the
    counting one where it has it)."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.scene_raycast_launch.restype = ctypes.c_int
    lib.scene_raycast_launch.argtypes = [p, p, p, p, p, p, ll, i, i, f, i, p]
    if hasattr(lib, "scene_raycast_faces"):
        lib.scene_raycast_faces.restype = ctypes.c_int
        lib.scene_raycast_faces.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    return lib


def _kernel_lib(kp: int, count_faces: bool = False) -> ctypes.CDLL:
    return bind(cuda_build.load(_KERNEL, raycast_defines(kp, count_faces)))


def scene_raycast_cuda_t(origin: torch.Tensor, direction: torch.Tensor,
                         table: torch.Tensor, *, t_max: float = _INF,
                         tile_shapes: int = 0):
    """(R, 2) float32 rays against a (N, KP, 4) `pack_scene_tables` table ->
    ``(t (R,), index (R,) int32, normal (R, 2))``. ``tile_shapes`` caps the
    shapes a block stages in shared memory at once (0: as many as 48 KB
    hold); the result does not depend on it."""
    return _cuda_or_plain(origin, direction, table, t_max, tile_shapes, None)


def scene_raycast_faces(origin: torch.Tensor, direction: torch.Tensor,
                        table: torch.Tensor, *, t_max: float = _INF,
                        tile_shapes: int = 0):
    """`scene_raycast_cuda_t` on the card through the library that counts
    its work: ``(result, (ray, face) pairs the kernel evaluated)``. It
    synchronises the card to read the count."""
    if origin.device.type != "cuda":
        raise ValueError(f"counts the kernel's work on a card, got {origin.device}")
    faces = ctypes.c_ulonglong(0)
    out = _cuda_or_plain(origin, direction, table, t_max, tile_shapes, faces)
    return out, int(faces.value)


def _cuda_or_plain(origin, direction, table, t_max, tile_shapes, faces):
    global LAUNCHES
    _check(origin, direction, table)
    if origin.device.type == "cpu":
        return scene_raycast_plain(origin, direction, table, t_max=t_max)
    if table.shape[1] > MAX_FACES:
        raise ValueError(f"the kernel takes at most {MAX_FACES} faces a shape, "
                         f"got {table.shape[1]}; use impl='torch'")
    if origin.data_ptr() % 8 or direction.data_ptr() % 8 or table.data_ptr() % 16:
        raise ValueError("rays must be 8-byte and the table 16-byte aligned")
    r = origin.shape[0]
    dev = origin.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    idx = torch.empty((r,), dtype=torch.int32, device=dev)
    normal = torch.empty((r, 2), dtype=torch.float32, device=dev)
    if r == 0:
        return t, idx, normal
    kp = int(table.shape[1])
    lib = _kernel_lib(kp, faces is not None)
    err = cuda_build.launch(
        dev, lib.scene_raycast_launch, origin.data_ptr(), direction.data_ptr(),
        table.data_ptr(), t.data_ptr(), idx.data_ptr(), normal.data_ptr(), r,
        int(table.shape[0]), kp, float(t_max), int(tile_shapes))
    if err != 0:
        raise RuntimeError(f"scene_raycast_launch failed: CUDA error {err}")
    LAUNCHES += 1
    if faces is not None:
        # the counters live on the launch's device
        with torch.cuda.device(dev):
            err = lib.scene_raycast_faces(ctypes.byref(faces))
            if err != 0:
                raise RuntimeError(f"scene_raycast_faces failed: CUDA error {err}")
    return t, idx, normal
