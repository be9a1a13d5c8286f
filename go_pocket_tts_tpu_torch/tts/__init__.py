"""TTS orchestration of the port: the service and the voice manifest."""

from go_pocket_tts_tpu_torch.tts.service import PCMChunk, Service
from go_pocket_tts_tpu_torch.tts.voices import Voice, VoiceManager

__all__ = ["Service", "PCMChunk", "Voice", "VoiceManager"]
