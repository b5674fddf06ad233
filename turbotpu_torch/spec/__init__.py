"""Bit-exact 3GPP spec tables (numpy only): the port's own copies of the
turbotpu/spec modules."""

from .trellis import N_STATES, TRELLIS, Trellis, build_trellis
from .qpp import LEGAL_K, MAX_K, QPP_PARAMS, nearest_legal_k, qpp_inv, qpp_params, qpp_perm
from .crc import (CRC24A_POLY, CRC24B_POLY, CRC_LEN, crc24, crc24a, crc24b,
                  crc_attach, crc_check, crc_matrix)
from .umts import umts_inv, umts_perm
from .rate_match import (circular_buffer_map, de_rate_match, rate_match,
                         select_indices, sub_block_maps)
from .segmentation import Segmentation, desegment, segment, segment_params
