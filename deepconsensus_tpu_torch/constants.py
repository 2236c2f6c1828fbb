"""Shared constants for DeepConsensus-TPU.

Mirrors the domain constants of the reference implementation
(reference: deepconsensus/utils/dc_constants.py:38-131) without depending
on pysam or tensorflow: cigar op codes are the BAM-spec integer codes.
"""
from __future__ import annotations

import enum

import numpy as np

__version__ = '0.1.0'

# Vocabulary. Gap must be index 0: the model's class 0 is "no base here"
# and zero-masked embeddings rely on it.
GAP = ' '
ALLOWED_BASES = 'ATCG'
SEQ_VOCAB = GAP + ALLOWED_BASES
SEQ_VOCAB_SIZE = len(SEQ_VOCAB)
GAP_INT = SEQ_VOCAB.index(GAP)

# Byte lookup table: ASCII code -> vocab index (gap for anything unknown).
_VOCAB_LUT = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(SEQ_VOCAB):
  _VOCAB_LUT[ord(_c)] = _i
VOCAB_LUT = _VOCAB_LUT

# Reverse lookup: vocab index -> ASCII byte.
VOCAB_BYTES = np.frombuffer(SEQ_VOCAB.encode('ascii'), dtype=np.uint8).copy()


# BAM-spec cigar operation codes (SAMv1 spec section 4.2; same ints pysam
# exposes as CMATCH..CBACK in the reference).
class Cigar(enum.IntEnum):
  MATCH = 0       # M
  INS = 1         # I
  DEL = 2         # D
  REF_SKIP = 3    # N
  SOFT_CLIP = 4   # S
  HARD_CLIP = 5   # H
  PAD = 6         # P
  EQUAL = 7       # =
  DIFF = 8        # X
  BACK = 9        # B


CIGAR_CHARS = 'MIDNSHP=XB'
CIGAR_OPS = {c: Cigar(i) for i, c in enumerate(CIGAR_CHARS)}

# Ops that consume bases of the read ("query-advancing"), used when mapping
# label truth coordinates (reference: dc_constants.py:47-49).
READ_ADVANCING_OPS = (Cigar.MATCH, Cigar.INS, Cigar.EQUAL, Cigar.DIFF)
READ_ADVANCING_OPS_ARR = np.array([int(x) for x in READ_ADVANCING_OPS])


class Issue(int, enum.Enum):
  TRUTH_ALIGNMENT_NOT_FOUND = 1
  SUPP_TRUTH_ALIGNMENT = 2


class Strand(int, enum.Enum):
  UNKNOWN = 0
  FORWARD = 1
  REVERSE = 2


NP_DATA_TYPE = np.float32

# Train/eval/test region splits per genome
# (reference: dc_constants.py:87-111).
ECOLI_REGIONS = {
    'TRAIN': (464253, 4178270),
    'EVAL': (0, 464252),
    'TEST': (4178271, 4642522),
}
TRAIN_REGIONS = {
    'HUMAN': (
        [str(i) for i in range(1, 19)]
        + ['chr%d' % i for i in range(1, 19)]
        + ['X', 'Y', 'chrX', 'chrY']
    ),
    'MAIZE': [str(i) for i in range(1, 9)] + ['chr%d' % i for i in range(1, 9)],
}
EVAL_REGIONS = {
    'HUMAN': ['21', '22', 'chr21', 'chr22'],
    'MAIZE': ['9', 'chr9'],
}
TEST_REGIONS = {
    'HUMAN': ['19', '20', 'chr19', 'chr20'],
    'MAIZE': ['10', 'chr10'],
}

# Feature keys of a batched example fed to the model
# (reference: dc_constants.py:114-125).
DC_FEATURES = [
    'rows',
    'label',
    'num_passes',
    'window_pos',
    'name',
    'ccs_base_quality_scores',
    'ec',
    'np_num_passes',
    'rq',
    'rg',
]

EMPTY_QUAL = 0

MAIN_EVAL_METRIC_NAME = 'eval/per_example_accuracy'
