"""Dataset registry and the readers.

Counterpart of `graphgpt_tpu/readers.py`: `NpzGraphStore` (:46-71),
`_load_big_graph` (:74), `SplitDataset` (:87-108), the PCQM4M-v2 split
policies (`_special_molecule_idx` :112-152, `apply_split_policies`
:155-199), the CEPDB/ZINC auxiliary corpora (:202-232),
`_graph_level_reader` (:234-266) with its ten registrations (:269-285),
`synthetic_mol` (:288), the edge-level reader (:314-371) with its four
registrations, the ogbn-proteins species mask (:373), the node-level
reader (:394-439) with its four registrations, and `read_dataset`. The
readers take no download; they read the on-disk npz contract
(`graphgpt_tpu/readers.py:1-27`):

Graph-level (`<data_dir>/<name>/graphs.npz`):
    node_attr   [sum_N, Dn] int
    edge_attr   [sum_E, De] int
    edge_index  [2, sum_E] int (GLOBAL node ids: graph g's edges are
                offset by node_ptr[g]; get() subtracts the offset back)
    node_ptr    [G+1], edge_ptr [G+1]
    y           [G, T] float
    pos         [sum_N, 3] float (optional)
    train_idx / valid_idx / test_idx  [.] int (optional; else a random
                80/10/10 split)

Edge-level (`<data_dir>/<name>/big_graph.npz`, as `tools/convert_ogb.py`
writes it):
    edge_index [2, E] int (both directions of an undirected edge),
    num_nodes (optional, else max id + 1), node_attr [N, Dn] (optional),
    edge_attr [E, De] (optional), {train,valid,test}_edge [P, 2],
    {valid,test}_edge_neg [P, 2] or [P, K, 2] (fixed eval negatives; K a
    positive, structured), {split}_relation [P] (wikikg2)

Node-level: the same big_graph.npz with y [N, T], {train,valid,test}_idx,
node_species [N] and x_mask [Dn] (optional).

Three differences from the JAX readers, all for the loader's spawned
workers: a member stored uncompressed in the dtype the reader wants is
memory-mapped, not copied; a graph-level store pickles as its path and
what was changed after it was read; and a big-graph dataset pickles as its
reader's arguments and its epoch (`data/sampling.py`), its CSR memory-mapped
from a cache file beside the store (`big_graph.csr.npz`, written at the
first read where the directory is writable). `structure_er` (:293) waits
for `GSTTokenizer`'s slice: asking for it raises.
"""

from __future__ import annotations

import os
import struct
import zipfile

import numpy as np

from .data.datasets import GraphsMapDataset, SyntheticMolDataset
from .data.graph import Graph, GraphBatchStore
from .data.partition import EnsembleDataset, RandomEdgesDataset
from .data.sampling import EgoEdgeDataset, EgoNodeDataset, build_csr_directed
from .utils.registry import Register

_readers = Register()
read_dataset = _readers.build

# the store's attribute of each npz member, and its dtype there
_MEMBERS = {
    "node_ptr": ("_node_ptr", np.int64),
    "edge_ptr": ("_edge_ptr", np.int64),
    "edge_index": ("edge_index", np.int32),
    "node_attr": ("node_attr", np.int32),
    "edge_attr": ("edge_attr", np.int32),
    "y": ("_ys", np.float32),
    "pos": ("_pos", np.float32),
    # OneID account->device pairs, graph-LOCAL node ids, sliced by
    # a2d_ptr; key_type [G] selects the reserved instruction token
    # (reference OneIDSmallDataset columns, dataset_utils.py:1303;
    # consumed by the a2d/a2d-stack instruction generators)
    "a2d": ("_a2d", np.int64),
    "a2d_ptr": ("_a2d_ptr", np.int64),
    "key_type": ("_key_type", np.int64),
}
_SPLITS = ("train", "valid", "test")
_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}


def _read_member(path: str, zf: zipfile.ZipFile, info: zipfile.ZipInfo, dtype) -> np.ndarray:
    """An npz member as `dtype` (None: as stored): memory-mapped (read only)
    where it is stored uncompressed in that dtype, as `np.savez` writes it;
    else read and converted."""
    if info.compress_type == zipfile.ZIP_STORED:
        with open(path, "rb") as f:
            f.seek(info.header_offset)
            head = f.read(30)  # the member's local file header
            if head[:4] == b"PK\x03\x04":
                name_len, extra_len = struct.unpack("<HH", head[26:30])
                f.seek(info.header_offset + 30 + name_len + extra_len)
                read_header = _HEADERS.get(np.lib.format.read_magic(f))
                if read_header is not None:
                    shape, fortran, stored = read_header(f)
                    if (dtype is None or stored == np.dtype(dtype)) and len(shape) and \
                            int(np.prod(shape)) > 0:
                        return np.memmap(path, dtype=stored, mode="r", offset=f.tell(),
                                         shape=shape, order="F" if fortran else "C")
    with zf.open(info) as f:
        arr = np.lib.format.read_array(f, allow_pickle=False)
    return arr if dtype is None else arr.astype(dtype)


def _read_npz(path: str, dtypes=None) -> dict:
    """Every member of an npz file by `_read_member`, each as its dtype in
    `dtypes` (else as stored)."""
    dtypes = dtypes or {}
    with zipfile.ZipFile(path) as zf:
        return {i.filename[:-4]: _read_member(path, zf, i, dtypes.get(i.filename[:-4]))
                for i in zf.infolist() if i.filename.endswith(".npy")}


class NpzGraphStore(GraphBatchStore):
    """Columnar many-graph storage read from the npz contract."""

    def __init__(self, path: str):
        self._open(path)

    def _open(self, path: str):
        self.path = path
        with zipfile.ZipFile(path) as zf:
            infos = {i.filename[:-4]: i for i in zf.infolist() if i.filename.endswith(".npy")}
            if "node_ptr" not in infos or "edge_ptr" not in infos:
                raise KeyError(f"{path}: the npz contract needs node_ptr and edge_ptr")
            read = {name: _read_member(path, zf, info, _MEMBERS[name][1]
                                       if name in _MEMBERS else np.int64)
                    for name, info in infos.items()
                    if name in _MEMBERS or name[:-4] in _SPLITS}
        for name, (attr, _) in _MEMBERS.items():
            setattr(self, attr, read.get(name))
        self.splits = {k: read[f"{k}_idx"] for k in _SPLITS if f"{k}_idx" in read}
        # what the file gave, so that a pickle can leave it out
        self._from_file = {attr: getattr(self, attr) for attr, _ in _MEMBERS.values()}
        self._from_file["splits"] = dict(self.splits)

    def __getstate__(self):
        """The path, and each attribute that no longer holds what the file
        gave (a split or a y column rewritten after loading)."""
        state = {}
        for k, v in self.__dict__.items():
            if k == "_from_file":
                continue
            if k == "splits":
                given = self._from_file["splits"]
                v = {s: (None if given.get(s) is a else a) for s, a in v.items()}
            elif k in self._from_file and v is self._from_file[k]:
                continue
            state[k] = v
        return state

    def __setstate__(self, state):
        self._open(state["path"])
        given = self.splits
        for k, v in state.items():
            if k == "splits":
                v = {s: (given[s] if a is None else a) for s, a in v.items()}
            setattr(self, k, v)


_BIG_DTYPES = {"edge_index": np.int32, "node_attr": np.int32, "edge_attr": np.int32}


def _load_big_graph(path: str):
    """(the big graph, every member of its npz by name), memory-mapped where
    `_read_member` can."""
    data = _read_npz(path, _BIG_DTYPES)
    ei = data["edge_index"]
    n = int(data["num_nodes"]) if "num_nodes" in data else int(ei.max()) + 1
    big = Graph(num_nodes=n, edge_index=ei, node_attr=data.get("node_attr"),
                edge_attr=data.get("edge_attr"), y=data.get("y"))
    return big, data


def _big_csr(path: str, big: Graph):
    """The big graph's `build_csr_directed`, memory-mapped from
    `big_graph.csr.npz` beside the store, which is written where it is
    missing or older than the store; held in memory where it cannot be."""
    cache = path[: -len(".npz")] + ".csr.npz"
    st = os.stat(path)
    stamp = np.asarray([st.st_size, st.st_mtime_ns], np.int64)
    if os.path.exists(cache):
        got = _read_npz(cache)
        if np.array_equal(got.get("stamp"), stamp):
            return got["indptr"], got["indices"], got["eids"]
    csr = build_csr_directed(big.num_nodes, big.edge_index)
    tmp = f"{cache}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, stamp=stamp, indptr=csr[0], indices=csr[1], eids=csr[2])
        os.replace(tmp, cache)
    except OSError:
        return csr
    got = _read_npz(cache)
    return got["indptr"], got["indices"], got["eids"]


class SplitDataset(GraphsMapDataset):
    """Map dataset carrying (train, valid, test) index splits."""

    def __init__(self, store: NpzGraphStore, permute: bool, seed: int):
        super().__init__(store, permute=permute, seed=seed)
        self._splits = store.splits

    def splits(self):
        n = len(self.store)
        if self._splits:
            return (
                self._splits.get("train", np.arange(n)),
                self._splits.get("valid", np.arange(0)),
                self._splits.get("test", np.arange(0)),
            )
        # random 80/10/10 fallback
        rng = np.random.default_rng(0)
        idx = rng.permutation(n)
        a, b = int(n * 0.8), int(n * 0.9)
        return idx[:a], idx[a:b], idx[b:]


# ---------------------------------------------------------------------------
# Split policies (reference _readers/pcqm4mv2.py:344-428)
# ---------------------------------------------------------------------------
def _special_molecule_idx(
    store: NpzGraphStore,
    *,
    edge0: bool = False,
    node1: bool = False,
    node2: bool = False,
    disconnected: bool = False,
) -> np.ndarray:
    """Indices of degenerate molecules (reference obtain_special_molecules,
    pcqm4mv2.py:405-428): zero edges / 1 node / 2 nodes / disconnected."""
    node_cnt = np.diff(store._node_ptr)
    edge_cnt = np.diff(store._edge_ptr)
    bad = np.zeros(len(node_cnt), bool)
    if edge0:
        bad |= edge_cnt == 0
    if node1:
        bad |= node_cnt == 1
    if node2:
        bad |= node_cnt == 2
    if disconnected:
        for g in np.flatnonzero(~bad):
            n = int(node_cnt[g])
            if n <= 1:
                continue
            s, e = store._edge_ptr[g], store._edge_ptr[g + 1]
            ei = store.edge_index[:, s:e] - store._node_ptr[g]
            parent = np.arange(n)

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            for a, b in ei.T:
                ra, rb = find(int(a)), find(int(b))
                if ra != rb:
                    parent[ra] = rb
            if len({find(i) for i in range(n)}) > 1:
                bad[g] = True
    return np.flatnonzero(bad)


def apply_split_policies(store: NpzGraphStore, splits, policy: dict):
    """Apply the reference's PCQM4M-v2 split manipulations to
    (train, valid, test) index arrays:

      - remove_special: drop degenerate molecules from every split
        (remove_special_molecules, pcqm4mv2.py:391-403)
      - true_valid: mix valid into train keeping `num_remained` (5000) as
        the new valid; seen valid samples double as test
        (add_valid_to_train, pcqm4mv2.py:344-368)
      - test_large: molecules with > 18 nodes from valid become test
        (get_large_mols_as_test_from_valid, pcqm4mv2.py:371-379)
      - duplicate_train: repeat train indices `rate` times
        (duplicate_sample_idx, pcqm4mv2.py:382-388)
    """
    train, valid, test = (np.asarray(s, np.int64) for s in splits)
    if not policy:
        return train, valid, test
    if policy.get("remove_special"):
        spec = policy["remove_special"]
        spec = spec if isinstance(spec, dict) else {"edge0": True, "node1": True}
        removed = set(_special_molecule_idx(store, **spec).tolist())
        keep = lambda idx: np.asarray(  # noqa: E731
            sorted(set(idx.tolist()) - removed), np.int64
        )
        train, valid, test = keep(train), keep(valid), keep(test)
    if policy.get("true_valid"):
        num_remained = int(policy.get("num_remained", 5000))
        rng = np.random.default_rng(42)
        perm = rng.permutation(len(valid))
        into_train = perm[:-num_remained]
        new_valid = valid[perm[-num_remained:]]
        cnt_test = min(num_remained, len(valid) - num_remained)
        test = valid[perm[:cnt_test]]
        train = np.concatenate([train, valid[into_train]])
        valid = new_valid
    if policy.get("test_large"):
        threshold = int(policy.get("large_threshold", 18))
        node_cnt = np.diff(store._node_ptr)
        test = valid[node_cnt[valid] > threshold]
    if policy.get("duplicate_train"):
        train = np.tile(train, int(policy["duplicate_train"]))
    return train, valid, test


# auxiliary pretrain corpora ensembled into PCQM training and the y column
# each keeps: CEPDB e_gap_alpha (y[:, 5]), ZINC Desolv_apolar (y[:, 2])
# (reference add_cepdb/add_zinc, _readers/pcqm4mv2.py:120-157)
_AUX_Y_COL = {"CEPDB": 5, "ZINC": 2}


class EnsembleSplitDataset(EnsembleDataset):
    """Base split dataset + auxiliary corpora appended to the TRAIN split
    only (reference EnsembleGraphsMapDataset wrapping,
    _readers/pcqm4mv2.py:120-157: valid/test stay on the base dataset)."""

    def __init__(self, base: "SplitDataset", auxes):
        super().__init__([base] + list(auxes))
        self.base = base

    def splits(self):
        tr, va, te = self.base.splits()
        extra = [
            np.arange(self._ptr[k], self._ptr[k + 1], dtype=np.int64)
            for k in range(1, len(self.datasets))
        ]
        if extra:
            tr = np.concatenate([tr] + extra)
        return tr, va, te


def _load_aux_dataset(cfg, name: str):
    path = os.path.join(cfg.tokenization.data_dir, name, "graphs.npz")
    store = NpzGraphStore(path)
    if store._ys is not None and store._ys.ndim == 2:
        col = _AUX_Y_COL.get(name, 0)
        store._ys = np.nan_to_num(store._ys[:, col : col + 1], nan=0.0)
    return GraphsMapDataset(store, permute=True, seed=cfg.training.seed)


def _graph_level_reader(name: str):
    @_readers(name)
    def _read(cfg, **kw):
        path = os.path.join(cfg.tokenization.data_dir, name, "graphs.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{name}: expected {path} (see graphgpt_torch.readers npz contract)"
            )
        store = NpzGraphStore(path)
        ds = SplitDataset(store, permute=True, seed=cfg.training.seed)
        policy = dict(getattr(cfg.tokenization, "dataset_policy", {}) or {})
        if policy:
            base = ds.splits()
            tr, va, te = apply_split_policies(store, base, policy)
            ds._splits = {"train": tr, "valid": va, "test": te}
        if policy.get("pos_percentile_bounds") and store._pos is not None:
            from .data.mol3d import build_dict_bounds

            ds.dict_bounds = build_dict_bounds(
                store._pos, cache_dir=os.path.dirname(path)
            )
        auxes = [
            _load_aux_dataset(cfg, aux)
            for aux in ("CEPDB", "ZINC")
            if policy.get(f"add_{aux.lower()}")
        ]
        if auxes:
            ens = EnsembleSplitDataset(ds, auxes)
            ens.dict_bounds = getattr(ds, "dict_bounds", None)
            return ens
        return ds

    return _read


for _name in (
    "pcqm4m-v2",
    "ogbg-molhiv",
    "ogbg-molpcba",
    "ZINC",
    "CEPDB",
    "reddit_threads",
    "triangles",
    # custom graph-level corpora (reference SpiceCircuitDataset,
    # OneIDSmallDataset, PygCustomMolDataset — dataset_utils.py:723,1303,1640);
    # their rdkit/netlist preprocessing happens offline into the npz contract
    # (tools/convert_ogb.py, tools/spice2graph.py)
    "spice-circuit",
    "oneid",
    "custom_mol",
):
    _graph_level_reader(_name)


@_readers("synthetic_mol")
def _read_synthetic(cfg, **kw):
    return SyntheticMolDataset(50_000, seed=cfg.training.seed)


@_readers("structure_er")
def _read_structure_er(cfg, **kw):
    raise NotImplementedError(
        "dataset 'structure_er': its structure tasks and GSTTokenizer wait for a later slice "
        "(ROADMAP.md queue 1 item 5)")


def _big_path(cfg, name: str) -> str:
    path = os.path.join(cfg.tokenization.data_dir, name, "big_graph.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{name}: expected {path} (see graphgpt_torch.readers npz "
                                "contract)")
    return path


def _reopen(source, state):
    """A big-graph dataset read again from its reader's arguments and brought
    to its pickled state (`data/sampling.py`'s `_Reopened`)."""
    kind, *args = source
    if kind == "edge":
        ds = _open_edge_level(*args, neg_keys=state.get("_neg_keys"))
    else:
        ds = _open_node_level(*args)
    return ds.restore(state)


# per edge-level dataset: its sampling settings (reference
# configs/tokenization/edge_lvl/*)
_EDGE_LEVEL = {}


def _edge_level_reader(name: str, default_depth_neighbors=((1, 14),), neg_ratio=1,
                       percent=100, relations: bool = False, sample_wgt: bool = False,
                       method: str = "global"):
    _EDGE_LEVEL[name] = dict(depth_neighbors=default_depth_neighbors, neg_ratio=neg_ratio,
                             percent=percent, relations=relations, sample_wgt=sample_wgt,
                             method=method)

    @_readers(name)
    def _read(cfg, data_split: str = "train", pretrain_mode: bool = False, **kw):
        return _open_edge_level(name, _big_path(cfg, name), cfg.training.seed, data_split,
                                pretrain_mode)

    return _read


def _open_edge_level(name, path, seed, data_split, pretrain_mode, neg_keys=None):
    s = _EDGE_LEVEL[name]
    big, data = _load_big_graph(path)
    pos = data.get(f"{data_split}_edge")
    neg = data.get(f"{data_split}_edge_neg")
    pos_attr = neg_cands = None
    if s["relations"] and f"{data_split}_relation" in data:
        # wikikg2 relation -> target edge attrs [ones, rel] and the
        # unique-relation candidate table (reference edge_level.py:241-262)
        rel = np.asarray(data[f"{data_split}_relation"], np.int64)
        pos_attr = np.stack([np.ones_like(rel), rel], axis=1)
        uniq = np.unique(rel)
        neg_cands = np.stack([np.ones_like(uniq), uniq], axis=1)
    ds = EgoEdgeDataset(
        big,
        depth_neighbors=s["depth_neighbors"],
        pos_edges=pos,
        neg_edges=neg,
        neg_ratio=s["neg_ratio"],
        percent=s["percent"] if data_split == "train" else 100,
        method=s["method"],
        seed=seed,
        pretrain_mode=pretrain_mode,
        pos_edge_attr=pos_attr,
        neg_edge_attr_candidates=neg_cands,
        sample_wgt=s["sample_wgt"] and data_split == "train",
        csr=_big_csr(path, big),
        neg_keys=neg_keys,
    )
    ds.source = ("edge", name, path, seed, data_split, pretrain_mode)
    return ds


_edge_level_reader("ogbl-ppa", ((1, 14),), neg_ratio=1, percent=50)
_edge_level_reader("ogbl-citation2", ((1, 14),), neg_ratio=1, percent=100)
_edge_level_reader("ogbl-ddi", ((1, 32),), neg_ratio=1, percent=100)
# wikikg2: relation edge-attrs + inverse-freq sample weights + local
# head/tail-corruption negatives (reference edge_level.py:210-300,
# dataset_map.py:369-388)
_edge_level_reader("ogbl-wikikg2", ((1, 8),), neg_ratio=1, percent=100, relations=True,
                   sample_wgt=True, method="local")


class SpeciesMask:
    """The ogbn-proteins species mask (reference _mask_species,
    node_level.py:302-309; `_make_species_mask_func` :373, a closure
    there): zero every node-attr column beyond the two global/local id
    columns for nodes sharing the TARGET node's species, preventing label
    leakage through label-as-feature columns. A module-level class, so that
    a spawned loader worker can unpickle it."""

    def __call__(self, g):
        species = g.extra.get("node_species")
        if species is None or g.node_attr is None or g.node_attr.shape[1] <= 2:
            return g
        root = int(np.asarray(g.root_n_id).reshape(-1)[0])
        tgt = species.reshape(-1)[root]
        keep = (species.reshape(-1) != tgt).astype(g.node_attr.dtype)  # [N]
        mask = np.repeat(keep[:, None], g.node_attr.shape[1], axis=1)
        mask[:, :2] = 1
        g.node_attr = g.node_attr * mask
        return g


# per node-level dataset: (depth_neighbors, species mask)
_NODE_LEVEL = {}


def _node_level_reader(name: str, depth_neighbors=((2, 10),), species_mask=False):
    _NODE_LEVEL[name] = (depth_neighbors, species_mask)

    @_readers(name)
    def _read(cfg, data_split: str = "train", pretrain_mode: bool = False, **kw):
        return _open_node_level(name, _big_path(cfg, name), cfg.training.seed, data_split,
                                pretrain_mode)

    return _read


def _open_node_level(name, path, seed, data_split, pretrain_mode):
    depth_neighbors, species_mask = _NODE_LEVEL[name]
    big, data = _load_big_graph(path)
    split_idx = data.get(f"{data_split}_idx")
    task_mask_func = None
    if species_mask and "node_species" in data:
        big.extra["node_species"] = np.asarray(data["node_species"], np.int64)
        task_mask_func = SpeciesMask()
    # root x_mask: multiply the seed node's attrs during fine-tuning to hide
    # label-as-feature columns (reference dataset_map.py:253-258, x_mask from
    # _mask_concat_node_label_as_feat)
    root_attr_mask = np.asarray(data["x_mask"], np.int64) if "x_mask" in data else None
    csr = _big_csr(path, big)
    ds = EgoNodeDataset(
        big,
        depth_neighbors=depth_neighbors,
        sample_idx=split_idx,
        seed=seed,
        pretrain_mode=pretrain_mode,
        task_mask_func=task_mask_func,
        root_attr_mask=root_attr_mask,
        csr=csr,
    )
    if pretrain_mode:
        # pretraining on big graphs ensembles node-ego with random-edge
        # subgraphs (reference EnsembleNodesEdgesMapDataset)
        rand_ds = RandomEdgesDataset(big, edges_per_sample=256,
                                     num_samples=len(ds) // 4 + 1, seed=seed, csr=csr)
        ds = EnsembleDataset([ds, rand_ds])
    ds.source = ("node", name, path, seed, data_split, pretrain_mode)
    return ds


for _name in ("ogbn-products", "ogbn-arxiv", "ogbn-papers100M"):
    _node_level_reader(_name)
_node_level_reader("ogbn-proteins", species_mask=True)
