"""Native (C++) host-side components, bound with ctypes: the protein
tokenizer and the padded embedding collator (tokenizer.cpp), built with g++
on first use (`build()`) into the git-ignored `build/` directory."""

from clip_dplm_tpu_torch.native.bindings import (  # noqa: F401
    available,
    build,
    pad_embedding_batch_native,
    tokenize_batch_native,
)
