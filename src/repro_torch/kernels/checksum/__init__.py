from repro_torch.kernels.checksum.kernel import (checksum_popcount,
                                                 checksum_tree)
from repro_torch.kernels.checksum.ops import CHECKSUM, checksum
from repro_torch.kernels.checksum.ref import (as_words, checksum_ref,
                                              checksum_ref_blocked,
                                              checksum_tree_ref,
                                              popcount_fig4)

__all__ = ["CHECKSUM", "as_words", "checksum", "checksum_popcount",
           "checksum_ref", "checksum_ref_blocked", "checksum_tree",
           "checksum_tree_ref", "popcount_fig4"]
