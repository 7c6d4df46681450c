r"""Bit-exact serial-equivalent BitBirch tree engine (host side).

Re-designed data layout, same decision semantics as the reference algorithm
(``bblean/bitbirch.py:162-526``): where the reference builds a graph of
``_BFNode`` / ``_BFSubcluster`` Python objects and recurses, this engine keeps
**flat id-indexed pools** (lists/arrays per field) and an **iterative
descend-then-unwind insert**, which

- removes recursion limits (trees pickle without recursion-depth hacks),
- keeps all cluster-feature state in contiguous per-node buffers friendly to
  vectorized kernels, and
- is the layout shared by the native C++ engine and the batch device engine.

Decision-order contract replicated exactly (validated by golden-fixture
conformance tests):

- argmax over node-entry Tanimoto picks the first maximal entry
  (``bitbirch.py:320``),
- leaf merges commit through the merge-accept criterion over candidate summed
  linear sums (``bitbirch.py:507-526``),
- node splits seed from the O(N) most-dissimilar pair; ties assign to the
  second node except the forced first seed (``bitbirch.py:190-211``),
- new split nodes enter the leaf linked-list *before* the node they split
  from (``bitbirch.py:182-188``),
- subclusters carry the minimal-uint "dtype class" used by the multiround
  file-exchange grouping (``bitbirch.py:476-499``).

Internal-node tracking entries do not accumulate molecule indices (the
reference accumulates them but never reads them back; skipping them saves
memory without changing any output).
"""

from __future__ import annotations

import typing as tp

import numpy as np
from numpy.typing import NDArray

from bblean_tpu_torch._merges import MergeAcceptFunction
from bblean_tpu_torch._np_similarity import centroid_from_sum
from bblean_tpu_torch.similarity import (
    _jt_sim_arr_vec_packed,
    jt_most_dissimilar_packed,
)
from bblean_tpu_torch.utils import min_safe_uint

__all__ = ["ExactTree"]

_NONE = -1


class ExactTree:
    r"""Flat-pool BitBirch CF-tree with serial-equivalent insertion order."""

    def __init__(self, branching_factor: int, n_features: int) -> None:
        self.branching_factor = branching_factor
        self.n_features = n_features
        self.n_bytes = (n_features + 7) // 8

        # -- node pools (index = node id) --
        self._node_subs: list[list[int]] = []
        self._node_cent_buf: list[NDArray[np.uint8]] = []
        # Leaf doubly-linked list; _NONE marks "not a leaf"
        self._node_prev: list[int] = []
        self._node_next: list[int] = []

        # -- subcluster pools (index = subcluster id) --
        self._sub_ls: list[NDArray[np.int64]] = []
        self._sub_n: list[int] = []
        self._sub_cent: list[NDArray[np.uint8]] = []
        self._sub_child: list[int] = []
        self._sub_dtype: list[str] = []
        self._sub_mols: list[list[int]] = []

        # Dummy head of the leaf linked list (never holds subclusters)
        self._dummy = self._new_node()
        self.root: int = _NONE

    # -- pool management -----------------------------------------------------

    def _new_node(self) -> int:
        nid = len(self._node_subs)
        self._node_subs.append([])
        self._node_cent_buf.append(
            np.empty((self.branching_factor + 1, self.n_bytes), dtype=np.uint8)
        )
        self._node_prev.append(_NONE)
        self._node_next.append(_NONE)
        return nid

    def _new_sub(
        self,
        ls: NDArray[np.int64],
        n: int,
        packed_centroid: NDArray[np.uint8],
        dtype_name: str,
        mols: list[int],
    ) -> int:
        sid = len(self._sub_n)
        self._sub_ls.append(ls)
        self._sub_n.append(n)
        self._sub_cent.append(packed_centroid)
        self._sub_child.append(_NONE)
        self._sub_dtype.append(dtype_name)
        self._sub_mols.append(mols)
        return sid

    def init_root(self) -> None:
        r"""Create the root as the first leaf, linked after the dummy head."""
        self.root = self._new_node()
        self._node_next[self._dummy] = self.root
        self._node_prev[self.root] = self._dummy

    @property
    def is_init(self) -> bool:
        return self._node_next[self._dummy] != _NONE

    def _centroids_view(self, node: int) -> NDArray[np.uint8]:
        return self._node_cent_buf[node][: len(self._node_subs[node])]

    def _append_sub(self, node: int, sid: int) -> None:
        subs = self._node_subs[node]
        self._node_cent_buf[node][len(subs)] = self._sub_cent[sid]
        subs.append(sid)

    # -- insertion -----------------------------------------------------------

    def insert_fp(
        self,
        unpacked_fp: NDArray[np.uint8],
        packed_fp: NDArray[np.uint8],
        mol_idx: int,
        accept_fn: MergeAcceptFunction,
        threshold: float,
    ) -> None:
        r"""Insert one fingerprint (a singleton cluster feature)."""
        sid = self._new_sub(
            unpacked_fp.astype(np.int64), 1, packed_fp, "uint8", [mol_idx]
        )
        self._insert(sid, accept_fn, threshold)

    def insert_buffer(
        self,
        buffer: NDArray[np.integer],
        mols: list[int],
        accept_fn: MergeAcceptFunction,
        threshold: float,
    ) -> None:
        r"""Insert a pre-aggregated cluster feature ``[linear_sum..., n]``."""
        n = int(buffer[-1])
        ls = buffer[:-1].astype(np.int64)
        sid = self._new_sub(
            ls,
            n,
            centroid_from_sum(ls, n, pack=True),
            np.dtype(buffer.dtype).name,
            mols,
        )
        self._insert(sid, accept_fn, threshold)

    def _insert(
        self, sid: int, accept_fn: MergeAcceptFunction, threshold: float
    ) -> None:
        node = self.root
        path: list[tuple[int, int]] = []  # (node, entry position) per level
        closest = 0
        # Greedy descent: follow the most-similar entry at every level
        while True:
            subs = self._node_subs[node]
            if not subs:
                self._append_sub(node, sid)
                return
            sims = _jt_sim_arr_vec_packed(
                self._centroids_view(node), self._sub_cent[sid]
            )
            closest = int(np.argmax(sims))
            child = self._sub_child[subs[closest]]
            if child == _NONE:
                break
            path.append((node, closest))
            node = child

        # Leaf action: merge into the closest subcluster or start a new one
        closest_id = self._node_subs[node][closest]
        if self._try_merge(closest_id, sid, accept_fn, threshold):
            self._node_cent_buf[node][closest] = self._sub_cent[closest_id]
            must_split = False
        else:
            self._append_sub(node, sid)
            must_split = len(self._node_subs[node]) > self.branching_factor

        # Unwind: propagate splits upward; above the topmost split, fold the
        # inserted CF into each tracking ancestor entry
        while path:
            pnode, pidx = path.pop()
            if must_split:
                child_node = self._sub_child[self._node_subs[pnode][pidx]]
                sc1, sc2 = self._split_node(child_node)
                self._node_subs[pnode][pidx] = sc1
                self._node_cent_buf[pnode][pidx] = self._sub_cent[sc1]
                self._append_sub(pnode, sc2)
                must_split = len(self._node_subs[pnode]) > self.branching_factor
            else:
                entry = self._node_subs[pnode][pidx]
                self._cf_add(entry, sid)
                self._node_cent_buf[pnode][pidx] = self._sub_cent[entry]

        if must_split:
            sc1, sc2 = self._split_node(self.root)
            new_root = self._new_node()
            self._append_sub(new_root, sc1)
            self._append_sub(new_root, sc2)
            self.root = new_root

    def _try_merge(
        self,
        closest: int,
        nominee: int,
        accept_fn: MergeAcceptFunction,
        threshold: float,
    ) -> bool:
        old_n = self._sub_n[closest]
        nom_n = self._sub_n[nominee]
        new_n = old_n + nom_n
        old_ls = self._sub_ls[closest]
        nom_ls = self._sub_ls[nominee]
        new_ls = old_ls + nom_ls
        if not accept_fn(threshold, new_ls, new_n, old_ls, nom_ls, old_n, nom_n):
            return False
        self._sub_ls[closest] = new_ls
        self._sub_n[closest] = new_n
        self._sub_cent[closest] = centroid_from_sum(new_ls, new_n, pack=True)
        self._sub_dtype[closest] = min_safe_uint(new_n).name
        self._sub_mols[closest].extend(self._sub_mols[nominee])
        return True

    def _cf_add(self, entry: int, sid: int) -> None:
        r"""Fold subcluster ``sid``'s CF into tracking ``entry`` (no mol ids)."""
        new_n = self._sub_n[entry] + self._sub_n[sid]
        new_ls = self._sub_ls[entry] + self._sub_ls[sid]
        self._sub_ls[entry] = new_ls
        self._sub_n[entry] = new_n
        self._sub_cent[entry] = centroid_from_sum(new_ls, new_n, pack=True)
        self._sub_dtype[entry] = min_safe_uint(new_n).name

    def _split_node(self, node2: int) -> tuple[int, int]:
        r"""Split an overfull node; returns the two new tracking entry ids."""
        node1 = self._new_node()
        if self._node_prev[node2] != _NONE:  # node2 is a leaf
            prev = self._node_prev[node2]
            self._node_prev[node1] = prev
            self._node_next[prev] = node1
            self._node_next[node1] = node2
            self._node_prev[node2] = node1

        idx1, _, sims1, sims2 = jt_most_dissimilar_packed(
            self._centroids_view(node2), self.n_features
        )
        to_node1 = sims1 > sims2
        # Force the first seed into node1 even when all centroids coincide
        to_node1[idx1] = True

        old_subs = self._node_subs[node2]
        self._node_subs[node2] = []
        zeros = np.zeros(self.n_features, dtype=np.int64)
        ls1, n1 = zeros.copy(), 0
        ls2, n2 = zeros.copy(), 0
        for pos, sid in enumerate(old_subs):
            if to_node1[pos]:
                self._append_sub(node1, sid)
                ls1 += self._sub_ls[sid]
                n1 += self._sub_n[sid]
            else:
                self._append_sub(node2, sid)
                ls2 += self._sub_ls[sid]
                n2 += self._sub_n[sid]
        sc1 = self._new_sub(
            ls1, n1, centroid_from_sum(ls1, n1, pack=True),
            min_safe_uint(max(n1, 1)).name, [],
        )
        sc2 = self._new_sub(
            ls2, n2, centroid_from_sum(ls2, n2, pack=True),
            min_safe_uint(max(n2, 1)).name, [],
        )
        self._sub_child[sc1] = node1
        self._sub_child[sc2] = node2
        return sc1, sc2

    # -- traversal / extraction ----------------------------------------------

    def iter_leaves(self) -> tp.Iterator[int]:
        r"""Yield leaf node ids in linked-list order."""
        leaf = self._node_next[self._dummy]
        while leaf != _NONE:
            yield leaf
            leaf = self._node_next[leaf]

    def leaf_sub_ids(self, sort: bool = True) -> list[int]:
        r"""Leaf subcluster ids, optionally stable-sorted by size descending."""
        ids = [sid for leaf in self.iter_leaves() for sid in self._node_subs[leaf]]
        if sort:
            ids.sort(key=lambda sid: self._sub_n[sid], reverse=True)
        return ids

    def sub_buffer(self, sid: int) -> NDArray[np.integer]:
        r"""CF buffer ``[linear_sum..., n]`` in this subcluster's dtype class."""
        buf = np.empty(self.n_features + 1, dtype=np.dtype(self._sub_dtype[sid]))
        buf[:-1] = self._sub_ls[sid]
        buf[-1] = self._sub_n[sid]
        return buf

    def sub_mols(self, sid: int) -> list[int]:
        return self._sub_mols[sid]

    def sub_n(self, sid: int) -> int:
        return self._sub_n[sid]

    def sub_packed_centroid(self, sid: int) -> NDArray[np.uint8]:
        return self._sub_cent[sid]

    def sub_dtype_name(self, sid: int) -> str:
        return self._sub_dtype[sid]

    # -- memory management ---------------------------------------------------

    @property
    def root_is_leaf(self) -> bool:
        return self.root != _NONE and self._node_prev[self.root] != _NONE

    def drop_internal_nodes(self) -> None:
        r"""Release internal-node state, keeping only the leaf chain.

        After this the tree can no longer accept inserts (matching reference
        ``delete_internal_nodes``, ``bitbirch.py:1092-1104``).
        """
        if self.root == _NONE or self.root_is_leaf:
            return
        leaves = set(self.iter_leaves())
        leaves.add(self._dummy)
        leaf_subs = {s for leaf in leaves for s in self._node_subs[leaf]}
        empty_u8 = np.empty(0, dtype=np.uint8)
        empty_i64 = np.empty(0, dtype=np.int64)
        for nid in range(len(self._node_subs)):
            if nid not in leaves:
                self._node_subs[nid] = []
                self._node_cent_buf[nid] = empty_u8.reshape(0, self.n_bytes)
        for sid in range(len(self._sub_n)):
            if sid not in leaf_subs:
                self._sub_ls[sid] = empty_i64
                self._sub_cent[sid] = empty_u8
                self._sub_mols[sid] = []
        self.root = _NONE
