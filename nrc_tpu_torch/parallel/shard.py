"""Multi-GPU: the frame in horizontal bands over a ``torch.distributed`` group.

Port of ``nrc_tpu/parallel/shard.py`` (the JAX package's ``shard_map`` over a
1-D device mesh, which replaces the reference's multi-GPU machinery,
``Raytracer.cpp:264-458`` and the compositor, ``Device.cpp:2651-2725``):

- pixel bands: rank k of D renders the rows [k H/D, (k + 1) H/D) with the
  rays the whole frame gives them (the band's offset enters the pixel
  indices that seed the TEA streams) and one training ray per tile of its
  band;
- replicated training: each rank assembles batches of its own records, and
  each of the frame's four steps averages the gradients over the ranks
  (one ``all_reduce`` of the packed gradients a step) before L2, Adam and
  the EMA; the steps are kept where the summed record count is above 0;
- level-sharded hash tables (``NetworkConfig.hash_shard_axis``): the table,
  its EMA and its moments hold rank k's block of L/D levels, and the lookup
  is ``ops/encodings.py::sharded_hash_grid_lookup`` (an ``all_gather`` of
  the positions, the lookup of this rank's levels, an ``all_to_all``); the
  table's gradient is then divided by D, not all-reduced: the lookup's
  adjoint already summed every rank's queries into the owner's rows
  (``nrc_tpu/parallel/shard.py:117-121``);
- the frame's stats are reduced: the mean loss, the summed record and
  traced-ray counts, so that every rank's tile-size schedule reads the same
  counts and picks the same tiles.

The data group is the default process group: NCCL on the card (one card a
rank), gloo on the CPU; ``init_data_group`` makes it, and a group whose
backend does not suit the renderer's device is refused. Each rank's frame is
one CUDA graph on the card, as a ``Renderer``'s: the collectives are
captured into it (NCCL's communicator is set up by an eager collective
first, ``ParallelRenderer.__init__``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..config import InputEncoding, NetworkConfig, adjust_tile_size
from ..models import network as N
from ..ops.encodings import level_block
from ..render.frame import FrameStats, frame_step
from ..render.renderer import Renderer


def backend_for(device: torch.device) -> str:
    """The collectives' backend for a device's tensors: NCCL on the card,
    gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_data_group(device, rank: int, world_size: int, port: int) -> None:
    """Join the default process group as ``rank`` of ``world_size``, at
    ``tcp://127.0.0.1:port``, with the backend for ``device``."""
    dist.init_process_group(backend_for(device), init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world_size)


def make_group(device) -> None:
    """Check the data group (``nrc_tpu/parallel/shard.py::make_mesh``): the
    default process group, whose backend must be the one for ``device``.
    Every collective of the port runs on it."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_data_group (or torch.distributed.init_process_group)")
    want, have = backend_for(device), dist.get_backend()
    if have != want:
        raise ValueError(f"a {have} group for {torch.device(device).type} tensors: the data group takes {want}")


def level_sharded(key: str, net_cfg: NetworkConfig) -> bool:
    """Whether the state tensor under checkpoint key ``key`` is level-sharded
    (``nrc_tpu/parallel/shard.py::net_state_specs``): the hash table, its EMA
    and its Adam moments when ``hash_shard_axis`` is set; every other tensor
    is replicated."""
    return (net_cfg.encoding == InputEncoding.HASH and net_cfg.hash_shard_axis is not None
            and key in N.GRID_KEYS)


def rank_state(tree, net_cfg: NetworkConfig, rank: int, world: int, device=None) -> N.NetworkState:
    """A whole JAX ``NetworkState`` as numpy (or a mapping of checkpoint
    keys, ``state_from_numpy``) carried to rank ``rank`` of ``world``: the
    replicated tensors whole, the level-sharded ones this rank's block."""
    block = level_block(net_cfg, rank, world) if level_sharded(N.GRID_KEYS[0], net_cfg) else None
    return N.state_from_numpy(tree, device, level_block=block)


class Band(NamedTuple):
    """One rank's share of the frame."""

    world: int
    rank: int
    rows: int           # image rows of the band
    row_offset: int     # its first row
    shard_tables: bool  # the hash table is level-sharded


def _grad_reduce(band: Band):
    """The mean of a list of gradients over the ranks, in one collective."""
    def reduce(grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat = flat / band.world
        return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
    return reduce


def _count_reduce(band: Band):
    def reduce(count):
        total = count.clone()
        dist.all_reduce(total)
        return total
    return reduce


def reduce_stats(stats: FrameStats, band: Band) -> FrameStats:
    """The frame's stats over the ranks, in one collective: the mean loss
    (``pmean``) and the summed record and traced-ray counts (``psum``),
    ``nrc_tpu/parallel/shard.py:127-131``."""
    packed = torch.stack([stats.loss.to(torch.float64), stats.num_train_records.to(torch.float64),
                          stats.traced_rays.to(torch.float64)])
    dist.all_reduce(packed)
    return FrameStats((packed[0] / band.world).to(torch.float32), packed[1].to(torch.int64),
                      packed[2].to(torch.int64))


def sharded_frame_step(band: Band, scene, net_state, image, camera, iteration_index, total_subframe,
                       cfg, net_cfg, learning_rate=None, branches=None):
    """One frame's band on this rank (``nrc_tpu/parallel/shard.py::
    sharded_frame_step``): ``image`` is the band [rows*W, 3]; the gradients
    are averaged over the ranks (the table's divided by D where it is
    level-sharded), the train branch decides on the summed record count, and
    the stats are reduced; ``branches`` as ``frame_step`` takes it (the
    band's render wavefront compacts its own lanes). Returns (the band's
    image', stats)."""
    if cfg.height != band.rows * band.world or band.rows % cfg.tile_size[1]:
        raise ValueError(f"a {cfg.height}-row frame over {band.world} ranks in whole {cfg.tile_size[1]}-row tiles")
    grid_grad_reduce = (lambda g: g / band.world) if band.shard_tables else None
    image, stats = frame_step(
        scene, net_state, image, camera, iteration_index, total_subframe, cfg, net_cfg, learning_rate,
        grad_reduce=_grad_reduce(band), count_reduce=_count_reduce(band), grid_grad_reduce=grid_grad_reduce,
        shard_rows=band.rows, row_offset=band.row_offset, branches=branches,
    )
    return image, reduce_stats(stats, band)


class ParallelRenderer(Renderer):
    """``Renderer`` over a band of the frame on each rank of the data group
    (``nrc_tpu/parallel/shard.py::ParallelRenderer``): the same surface,
    ``render_frame``, ``flush_stats``, ``render``, ``image_hdr``,
    ``screenshot`` and the live edits. Every rank renders the same frames in
    step (the collectives pair them). Each rank keeps the whole image: a
    frame writes its band, then gathers every rank's band (an
    ``all_gather``, part of the frame's graph), so that ``image``,
    ``image_hdr``, ``screenshot`` and a render state read the whole frame on
    any rank. The tile height must divide the band: the schedule halves a
    tile height that does not."""

    def __init__(self, scene, system, net_cfg: Optional[NetworkConfig] = None, **kw):
        if kw.get("spans"):
            raise ValueError("spans are recorded on a single-device Renderer, not on a band")
        device = torch.device(kw.get("device", "cuda"))
        make_group(device)
        world, rank = dist.get_world_size(), dist.get_rank()
        height = system.resolution[1]
        if height % world:
            raise ValueError(f"height {height} does not divide over {world} ranks")
        rows = height // world
        shard_tables = net_cfg is not None and net_cfg.hash_shard_axis is not None
        self.band = Band(world, rank, rows, rank * rows, shard_tables)
        # a band walks its primaries: the raster bins the whole screen
        # (nrc_tpu/render/frame.py:213)
        super().__init__(scene, system, net_cfg, raster_primary=False, **kw)
        if rows % self.cfg.tile_size[1]:
            raise ValueError(f"tile height {self.cfg.tile_size[1]} does not divide the {rows}-row band")
        self._band_image = self._image.view(height, -1, 3)[rank * rows:(rank + 1) * rows].view(-1, 3)
        if self.device.type == "cuda":
            # NCCL sets up its communicator at the first collective: eagerly,
            # before any frame is captured
            probe = torch.zeros(1, device=self.device)
            dist.all_reduce(probe)
            torch.cuda.synchronize(self.device)

    @property
    def lead(self) -> bool:
        return self.band.rank == 0

    @property
    def state_block(self) -> Optional[slice]:
        """This rank's block of the table's levels where the table is
        level-sharded, else None (the whole table)."""
        if not level_sharded(N.GRID_KEYS[0], self.net_cfg):
            return None
        return level_block(self.net_cfg, self.band.rank, self.band.world)

    def _init_state(self, seed: int) -> N.NetworkState:
        """The whole state from ``seed`` (the same on every rank), its
        level-sharded tensors cut to this rank's block."""
        state = super()._init_state(seed)
        if self.state_block is None or state.grid is None:
            return state
        return N.state_from_numpy(N.state_to_numpy(state), self.device, level_block=self.state_block)

    def net_state_arrays(self) -> dict:
        """The whole network state as numpy, as the JAX package's file holds
        a level-sharded state: the table, its EMA and its moments gathered
        from every rank's block in level order (one ``all_gather``), the
        replicated tensors as this rank holds them. A collective where the
        table is level-sharded: every rank calls it."""
        arrays = N.state_to_numpy(self.net_state)
        st = self.net_state
        if self.state_block is None or st.grid is None:
            return arrays
        blocks = torch.stack([st.grid.table, st.ema_grid.table, st.opt.mu_grid, st.opt.nu_grid])
        gathered = blocks.new_empty((self.band.world,) + tuple(blocks.shape))
        dist.all_gather(list(gathered.unbind(0)), blocks.contiguous())
        whole = gathered.transpose(0, 1).reshape(len(N.GRID_KEYS), -1, *blocks.shape[2:]).cpu().numpy()
        arrays.update({key: whole[i].copy() for i, key in enumerate(N.GRID_KEYS)})
        return arrays

    def _frame(self) -> FrameStats:
        with torch.no_grad():
            image, stats = sharded_frame_step(
                self.band, self.device_scene, self.net_state, self._band_image, self._camera,
                self._counters[0], self._counters[1], self.cfg, self.net_cfg, self.learning_rate,
                branches=self._branches,
            )
            dist.all_gather(list(self._image.view(self.band.world, -1, 3).unbind(0)), image)
            self.traced_rays.add_(stats.traced_rays)
            self._counters.add_(1)
        return stats

    def _next_tile_size(self, num_train_records: int) -> tuple:
        tsx, tsy = adjust_tile_size(self.cfg.tile_size, num_train_records)
        while self.band.rows % tsy:
            tsy //= 2
        return tsx, tsy
