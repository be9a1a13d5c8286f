"""Text front-end: normalization, preparation, chunking, tokenizer."""

from go_pocket_tts_tpu_torch.text.normalize import EmptyTextError, normalize
from go_pocket_tts_tpu_torch.text.prepare import (
    DEFAULT_MIMI_FRAME_RATE,
    ChunkMetadata,
    estimate_max_frames,
    prepare_chunks,
    prepare_text,
)
from go_pocket_tts_tpu_torch.text.chunk import chunk_by_sentence, split_sentences

__all__ = [
    "EmptyTextError",
    "normalize",
    "DEFAULT_MIMI_FRAME_RATE",
    "ChunkMetadata",
    "estimate_max_frames",
    "prepare_chunks",
    "prepare_text",
    "chunk_by_sentence",
    "split_sentences",
]
