"""Biological modality enums: route data through the right encoder or
projection by declared type and scale. Copy of `clip_dplm_tpu/types.py`."""

import enum


class BiologicalDataType(enum.Enum):
    PROTEIN = "protein"
    GENE = "gene"
    CELL_STATE = "cell_state"
    PERTURBATION = "perturbation"
    RNA_MOTIF = "rna_motif"


class BiologicalScale(enum.Enum):
    SINGLE_CELL = "single_cell"
    CELL_TYPE = "cell_type"
    TISSUE = "tissue"
