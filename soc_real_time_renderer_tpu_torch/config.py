"""Configuration & per-frame globals.

Counterpart of the JAX package's ``config.py``:

* :class:`RenderConfig` — static configuration, the same field names and
  defaults, so the two configs stay interchangeable.  The fields that
  only choose or tile a TPU kernel (``ssao_impl``, ``taa_impl``,
  ``ssao_window_*``) are not read here: the port always computes the
  exact semantics, through the CUDA kernel on a card.
* :class:`ShaderGlobals` and its parts — frozen dataclasses of tensors,
  built on the host in numpy exactly as the reference does
  (``renderer.cpp:72-133``) and moved to ``device`` by :func:`upload`:
  on a card in one packed, non-blocking copy, whose leaves keep their
  host values for the proof checks (``utils/trace.read_back``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .utils import mathutil as mu
from .utils import trace

MAX_POINT_LIGHTS = 128  # shared.inl:84
MAX_SPOT_LIGHTS = 128   # shared.inl:85
AUTO_EXPOSURE_BIN_COUNT = 256  # shared.inl:38


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when the caller names
    one, else the first CUDA card.  With no card and no explicit device
    it raises instead of falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the renderer runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run its plain PyTorch versions "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def tree_to(obj, device):
    """Dataclass of arrays -> the same dataclass with every leaf a tensor
    on `device` (numpy leaves keep their dtype; None stays None).  Each
    leaf copied from the host to a device counts in trace.counters."""
    if obj is None:
        return None
    device = torch.device(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    if not isinstance(obj, torch.Tensor):
        obj = torch.from_numpy(np.array(obj, order="C"))
    if obj.device.type == "cpu" and device.type != "cpu":
        trace.count_h2d(obj.numel() * obj.element_size())
    return obj.to(device)


# bytes from the start of one packed leaf to the next: every leaf's
# slice is aligned for any dtype's view
PACK_ALIGN = 256
_DTYPES: dict = {}      # numpy dtype -> torch dtype


class _Slot:
    """A host leaf's place in a packed buffer: `shape` elements of
    `dtype` (`np_dtype` on the host), contiguous from byte `offset`."""
    __slots__ = ("offset", "np_dtype", "dtype", "shape", "strides")

    def __init__(self, offset, np_dtype, shape):
        self.offset, self.np_dtype, self.shape = offset, np_dtype, shape
        self.dtype = _DTYPES.get(np_dtype)
        if self.dtype is None:
            self.dtype = _DTYPES[np_dtype] = torch.from_numpy(
                np.empty(0, np_dtype)).dtype
        strides, n = [], 1
        for d in reversed(shape):
            strides.append(n)
            n *= d
        self.strides = tuple(reversed(strides))


def pack(obj):
    """(buffer, tree, nbytes): every host leaf of `obj` (a dataclass tree,
    or a tuple of them; numpy arrays, scalars and CPU tensors of a numpy
    dtype) written into one uint8 numpy buffer at PACK_ALIGN-byte
    offsets, in :func:`tree_to`'s order; `tree` is `obj` with each such
    leaf replaced by its _Slot, a leaf on a device kept as it is;
    `nbytes` counts the leaves' own bytes.  A dataclass that recurs in
    `obj` (a first frame's camera_prev, which is its camera) is packed
    once and stays one object."""
    p = _Packing()
    tree = p.walk(obj)
    buf = np.zeros(p.size, np.uint8)
    for offset, raw in p.chunks:
        buf[offset:offset + raw.size] = raw
    return buf, tree, p.nbytes


def unpack(tree, block: torch.Tensor, host: np.ndarray | None = None):
    """`tree` (from :func:`pack`) with each _Slot replaced by its view of
    `block` (a uint8 tensor of the packed buffer's size): the contiguous
    `.view(dtype).view(shape)` of its slice, made as one as_strided
    view.  With `host`, the packed buffer that `block` is a copy of, each
    view is recorded as a mirror of its slice of the host's
    (trace.mirror), valid until `block` is written in place."""
    return _Unpacking(block, host).walk(tree)


class _Walk:
    """A walk over a tree of dataclasses and tuples that maps each other
    leaf by `leaf` and keeps a recurring dataclass one object.  (A class,
    not a nested function: that would be a reference cycle keeping the
    tree's tensors alive until the collector runs.)"""

    def __init__(self):
        self.memo = {}

    def walk(self, x):
        if dataclasses.is_dataclass(x):
            done = self.memo.get(id(x))
            if done is None:
                done = self.memo[id(x)] = dataclasses.replace(x, **{
                    f.name: self.walk(getattr(x, f.name))
                    for f in dataclasses.fields(x)})
            return done
        if isinstance(x, tuple):
            return tuple(self.walk(y) for y in x)
        return None if x is None else self.leaf(x)


class _Packing(_Walk):
    def __init__(self):
        super().__init__()
        self.chunks = []
        self.size = self.nbytes = 0

    def leaf(self, x):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                return x
            x = x.detach().numpy()
        a = np.asarray(x)
        raw = a.reshape(-1).view(np.uint8)
        self.chunks.append((self.size, raw))
        slot = _Slot(self.size, a.dtype, a.shape)
        self.size += max(1, -(-raw.size // PACK_ALIGN)) * PACK_ALIGN
        self.nbytes += raw.size
        return slot


class _Unpacking(_Walk):
    def __init__(self, block, host):
        super().__init__()
        self.block, self.host, self.typed = block, host, {}

    def leaf(self, x):
        if not isinstance(x, _Slot):
            return x
        whole = self.typed.get(x.dtype)
        if whole is None:
            whole = self.typed[x.dtype] = self.block.view(x.dtype)
        t = whole.as_strided(x.shape, x.strides,
                             x.offset // whole.element_size())
        if self.host is not None:
            n = t.numel() * whole.element_size()
            trace.mirror(t, self.host[x.offset:x.offset + n].view(
                x.np_dtype).reshape(x.shape))
        return t


def upload(obj, device):
    """:func:`tree_to` of `obj` (a dataclass tree or a tuple of them) in
    one copy.  On the CPU it is tree_to, leaf by leaf.  On any other
    device the host leaves are packed (:func:`pack`; pinned where the
    device is a card, so the copy does not wait for the card's queue) and
    copied once, non-blocking, into a device block whose views are the
    leaves (:func:`unpack`); each leaf keeps its host values as a mirror
    for :func:`~.utils.trace.read_back`.  A pinned buffer is not reused
    before its copy has run: the caching host allocator holds it until
    the event the copy records.  Counts one copy and the leaves' bytes in
    trace.counters."""
    device = torch.device(device)
    if device.type == "cpu":
        if isinstance(obj, tuple):
            return tuple(tree_to(o, device) for o in obj)
        return tree_to(obj, device)
    host, tree, nbytes = pack(obj)
    if not host.size:                   # every leaf already there
        return tree
    staging = torch.from_numpy(host)
    if device.type == "cuda":
        staging = staging.pin_memory()
    block = torch.empty(host.shape, dtype=torch.uint8, device=device)
    block.copy_(staging, non_blocking=True)
    trace.count_h2d(nbytes)
    return unpack(tree, block, host)


def tree_map(fn, *objs):
    """Dataclass trees of tensors -> the same tree with each leaf
    fn(*leaves) (None stays None)."""
    obj = objs[0]
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, *(getattr(o, f.name) for o in objs))
            for f in dataclasses.fields(obj)})
    return fn(*objs)


def view_count(g) -> int | None:
    """The number of views of ShaderGlobals `g`: None for one frame's
    globals, B where every leaf carries a leading view axis (B, ...),
    read off ``frame_counter``'s shape."""
    return None if g.frame_counter.dim() == 0 else g.frame_counter.shape[0]


def stack_views(trees):
    """A list of B dataclass trees (ShaderGlobals, RenderHistory) -> one
    tree whose leaves are stacked on a new leading view axis (B, ...).
    A stacked leaf whose every view has a host mirror (:func:`upload`)
    gets the stack of those as its own."""
    def stack(*xs):
        out = torch.stack(xs)
        hosts = []
        for x in xs:
            h = trace.mirrored(x)
            if h is None:
                return out
            hosts.append(h)
        trace.mirror(out, np.stack(hosts))
        return out
    return tree_map(stack, *trees)


def select_view(tree, i: int):
    """View `i` of a batched dataclass tree (every leaf indexed on its
    leading view axis)."""
    return tree_map(lambda x: x[i], tree)


@dataclass(frozen=True)
class CameraMatrices:
    """One camera matrix set (shared.inl:48-60)."""
    projection: torch.Tensor        # (4,4) jittered projection
    inv_projection: torch.Tensor
    view: torch.Tensor
    inv_view: torch.Tensor
    projection_view: torch.Tensor
    inv_projection_view: torch.Tensor
    position: torch.Tensor          # (3,)
    jitter: torch.Tensor            # (2,) ndc-space jitter actually applied

    @staticmethod
    def from_proj_view(proj: np.ndarray, view: np.ndarray, position,
                       jitter=(0.0, 0.0), device="cpu"):
        proj = _f32(proj)
        view = _f32(view)
        inv_p = np.linalg.inv(proj).astype(np.float32)
        inv_v = np.linalg.inv(view).astype(np.float32)
        return upload(CameraMatrices(
            projection=proj,
            inv_projection=inv_p,
            view=view,
            inv_view=inv_v,
            projection_view=(proj @ view).astype(np.float32),
            inv_projection_view=np.linalg.inv(proj @ view).astype(np.float32),
            position=_f32(position),
            jitter=_f32(jitter),
        ), device)


@dataclass(frozen=True)
class SunInfo:
    """Sun/shadow parameters (shared.inl:24-37, defaults renderer.cpp:104-133)."""
    projection: torch.Tensor        # (4,4) ortho +-16
    view: torch.Tensor
    projection_view: torch.Tensor
    terrain_y_clip_trick: torch.Tensor  # (4,) P*V*(0,1,0,0)
    position: torch.Tensor          # (3,)
    direction: torch.Tensor         # (3,)
    exponential_factor: torch.Tensor  # -80.0
    darkening_factor: torch.Tensor    # 1.0
    bias: torch.Tensor                # 1e-4
    intensity: torch.Tensor           # 1.0

    @staticmethod
    def create(angle_direction_deg=(4.0, 0.0, 0.0),
               position=(-3.2, 40.0, -4.0), planes=16.0,
               exponential_factor=-80.0, darkening_factor=1.0,
               bias=1e-4, intensity=1.0, device="cpu"):
        """Mirrors renderer.cpp:108-133 (angle default renderer.hpp:67)."""
        d = np.array([0.0, -1.0, 0.0], np.float32)
        d = mu.rotate_x(d, np.radians(angle_direction_deg[0]))
        d = mu.rotate_y(d, np.radians(angle_direction_deg[1]))
        d = mu.rotate_z(d, np.radians(angle_direction_deg[2]))
        proj = mu.orthographic(-planes, planes, -planes, planes, -planes,
                               planes)
        pos = _f32(position)
        view = mu.look_at(pos, pos + d,
                          np.array([0.0, -1.0, 0.0], np.float32))
        pv = (proj @ view).astype(np.float32)
        trick = pv @ np.array([0.0, 1.0, 0.0, 0.0], np.float32)
        return upload(SunInfo(
            projection=proj, view=view, projection_view=pv,
            terrain_y_clip_trick=_f32(trick), position=pos,
            direction=_f32(d),
            exponential_factor=_f32(exponential_factor),
            darkening_factor=_f32(darkening_factor),
            bias=_f32(bias), intensity=_f32(intensity),
        ), device)


@dataclass(frozen=True)
class LightArrays:
    """Fixed-capacity light arrays (shared.inl:82-85), struct of arrays."""
    point_position: torch.Tensor   # (128, 3)
    point_color: torch.Tensor      # (128, 3)
    point_intensity: torch.Tensor  # (128,)
    point_count: torch.Tensor      # () int32
    spot_position: torch.Tensor    # (128, 3)
    spot_direction: torch.Tensor   # (128, 3)
    spot_color: torch.Tensor       # (128, 3)
    spot_intensity: torch.Tensor   # (128,)
    spot_cut_off: torch.Tensor     # (128,) cos(inner)
    spot_outer_cut_off: torch.Tensor  # (128,) cos(outer)
    spot_count: torch.Tensor       # () int32

    @staticmethod
    def empty(device="cpu"):
        z3 = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
        z1 = np.zeros((MAX_POINT_LIGHTS,), np.float32)
        return upload(LightArrays(
            point_position=z3, point_color=z3, point_intensity=z1,
            point_count=np.int32(0),
            spot_position=z3, spot_direction=z3, spot_color=z3,
            spot_intensity=z1, spot_cut_off=z1, spot_outer_cut_off=z1,
            spot_count=np.int32(0),
        ), device)


@dataclass(frozen=True)
class ShaderGlobals:
    """Per-frame globals (shared.inl:47-133), every leaf a tensor."""
    camera: CameraMatrices
    camera_prev: CameraMatrices
    camera_near_clip: torch.Tensor
    camera_far_clip: torch.Tensor
    elapsed_time: torch.Tensor
    delta_time: torch.Tensor
    frame_counter: torch.Tensor     # () int32

    sun: SunInfo
    lights: LightArrays

    terrain_offset: torch.Tensor
    terrain_scale: torch.Tensor
    terrain_height_scale: torch.Tensor
    terrain_midpoint: torch.Tensor
    terrain_delta: torch.Tensor
    terrain_min_depth: torch.Tensor
    terrain_max_depth: torch.Tensor
    terrain_y_clip_trick: torch.Tensor
    terrain_previous_y_clip_trick: torch.Tensor

    filter_radius: torch.Tensor

    ssao_bias: torch.Tensor
    ssao_radius: torch.Tensor

    ambient: torch.Tensor
    ambient_occlussion_strength: torch.Tensor  # (sic, reference spelling)
    emissive_bloom_strength: torch.Tensor

    focal_length: torch.Tensor
    plane_in_focus: torch.Tensor
    aperture: torch.Tensor

    adjustment_speed: torch.Tensor
    log_min_luminance: torch.Tensor
    log_max_luminance: torch.Tensor
    target_luminance: torch.Tensor

    saturation: torch.Tensor
    agx_ds_linear_section: torch.Tensor
    peak: torch.Tensor
    compression: torch.Tensor

    @staticmethod
    def create(camera: CameraMatrices | None = None,
               camera_prev: CameraMatrices | None = None,
               sun: SunInfo | None = None,
               lights: LightArrays | None = None,
               near_clip=0.1, far_clip=1000.0, device="cpu", **overrides):
        """Defaults exactly as renderer.cpp:72-133.  device=None leaves
        every leaf where it is (host arrays on the host), for a caller
        that uploads the tree together with others (:func:`upload`)."""
        if camera is None:
            camera = CameraMatrices.from_proj_view(np.eye(4), np.eye(4),
                                                   (0, 0, 0))
        camera_prev = camera_prev if camera_prev is not None else camera
        sun = sun if sun is not None else SunInfo.create()
        lights = lights if lights is not None else LightArrays.empty()
        target_luminance = 0.2140
        # renderer.cpp:100-102: log bounds remapped through the target.
        log_min = np.log2(target_luminance / np.exp2(-15.0))
        log_max = np.log2(target_luminance / np.exp2(15.0))
        vals = dict(
            camera=camera, camera_prev=camera_prev,
            camera_near_clip=_f32(near_clip), camera_far_clip=_f32(far_clip),
            elapsed_time=_f32(0.0), delta_time=_f32(1.0 / 60.0),
            frame_counter=np.int32(0),
            sun=sun, lights=lights,
            terrain_offset=_f32([0.0, 0.0, 0.0]),
            terrain_scale=_f32([100.0, 100.0]),
            terrain_height_scale=_f32(70.0),
            terrain_midpoint=_f32(0.2),
            terrain_delta=_f32(8.0),
            terrain_min_depth=_f32(1.0),
            terrain_max_depth=_f32(100.0),
            terrain_y_clip_trick=sun.terrain_y_clip_trick,
            terrain_previous_y_clip_trick=sun.terrain_y_clip_trick,
            filter_radius=_f32(0.005),
            ssao_bias=_f32(0.025), ssao_radius=_f32(0.3),
            ambient=_f32([0.1, 0.1, 0.1]),
            ambient_occlussion_strength=_f32(1.2),
            emissive_bloom_strength=_f32(2.0),
            focal_length=_f32(5.0), plane_in_focus=_f32(1.0),
            aperture=_f32(8.0),
            adjustment_speed=_f32(1.0),
            log_min_luminance=_f32(log_min),
            log_max_luminance=_f32(log_max),
            target_luminance=_f32(target_luminance),
            saturation=_f32(1.0), agx_ds_linear_section=_f32(0.18),
            peak=_f32(1.0), compression=_f32(0.15),
        )
        vals.update(overrides)
        g = ShaderGlobals(**vals)
        return g if device is None else upload(g, device)


@dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (the JAX package's RenderConfig,
    field for field)."""
    width: int = 1280
    height: int = 720
    shadow_resolution: int = 4096
    bloom_mip_count: int = 4
    ssao_kernel_size: int = 26
    half_res_ssao: bool = True
    ssao_impl: str = "pallas"
    ssao_window_rows: int = 64
    ssao_window_lanes: int = 384
    taa_impl: str = "pallas"
    half_res_clouds: bool = True
    enable_shadows: bool = True
    enable_hiz: bool = True
    enable_terrain: bool = False
    enable_ssao: bool = True
    enable_ssr: bool = False
    composite_ssr: bool = False
    enable_clouds: bool = True
    cloud_noise_mode: str = "texture"
    cloud_impl: str = "lut"
    cloud_fullscreen_rays: bool = False
    enable_bloom: bool = True
    enable_taa: bool = True
    enable_auto_exposure: bool = True
    enable_depth_of_field: bool = False
    enable_volumetric_light: bool = False
    max_point_lights: int = 128
    max_spot_lights: int = 128
    terrain_patches: int = 100
    terrain_subdiv: int = 2

    @property
    def resolution(self):
        return (self.width, self.height)

    @property
    def half_resolution(self):
        return (self.width // 2, self.height // 2)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def plastic_jitter(index, width, height):
    """TAA sub-pixel jitter, application.cpp:113-127 (plastic-number
    sequence, index mod 32) in float32 numpy.  Returns (2,) NDC jitter."""
    g = 1.32471795724474602596
    a1 = np.float32(1.0 / g)
    a2 = np.float32(1.0 / (g * g))
    i = np.float32(int(index) % 32)
    jx = np.mod(np.float32(0.5) + a1 * (i + np.float32(1.0)),
                np.float32(1.0)) - np.float32(0.5)
    jy = np.mod(np.float32(0.5) + a2 * (i + np.float32(1.0)),
                np.float32(1.0)) - np.float32(0.5)
    return np.array([jx / np.float32(width), jy / np.float32(height)],
                    np.float32)
