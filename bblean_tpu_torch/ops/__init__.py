r"""Device ops of the PyTorch port (packing, popcount, Tanimoto, iSIM; the
merge criteria, tile search, k-means and t-SNE live in their modules)."""

from bblean_tpu_torch.ops.packing import (
    pack_fingerprints_device,
    unpack_fingerprints_device,
)
from bblean_tpu_torch.ops.popcount import popcount_device, popcount_rows
from bblean_tpu_torch.ops.tanimoto import (
    tanimoto_matmul,
    tanimoto_packed_arr_vec,
)
from bblean_tpu_torch.ops.isim import (
    isim_from_sums,
    isim_radius_compl_from_sums,
)

__all__ = [
    "pack_fingerprints_device",
    "unpack_fingerprints_device",
    "popcount_device",
    "popcount_rows",
    "tanimoto_matmul",
    "tanimoto_packed_arr_vec",
    "isim_from_sums",
    "isim_radius_compl_from_sums",
]
