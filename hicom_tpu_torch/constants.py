"""Model-wide constants.

Mirrors the reference constant surface (``upstream hicom/constants.py:1-32``)
so that data pipelines, token splicing and eval harnesses agree on sentinel values.
"""

IGNORE_INDEX = -100

# Sentinel token ids spliced into text token streams to mark where visual
# embeddings are inserted. Negative so they can never collide with a real
# vocabulary id.
IMAGE_TOKEN_INDEX = -200
VIDEO_TOKEN_INDEX = -201
AUDIO_TOKEN_INDEX = -202

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_AUDIO_TOKEN = "<audio>"

MODAL_INDEX_MAP = {
    DEFAULT_IMAGE_TOKEN: IMAGE_TOKEN_INDEX,
    DEFAULT_VIDEO_TOKEN: VIDEO_TOKEN_INDEX,
    DEFAULT_AUDIO_TOKEN: AUDIO_TOKEN_INDEX,
}

NUM_FRAMES = 8
MAX_FRAMES = 32
NUM_FRAMES_PER_SECOND = 1
