"""Data substrate (port of ``repro/data``): tokenizer, packing,
deterministic sharded loaders.  Pure numpy; batches are numpy arrays that
the models take as they are."""

from repro_torch.data.pipeline import (
    PackedDataset,
    SyntheticLM,
    SyntheticSeq2Task,
    pack_documents,
)
from repro_torch.data.tokenizer import ByteTokenizer
