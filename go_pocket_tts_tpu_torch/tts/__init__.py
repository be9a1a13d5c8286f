"""TTS orchestration of the port: the service, the voice manifest, voice
cloning, the parity harness and the torch and cli backends."""

from go_pocket_tts_tpu_torch.tts.service import PCMChunk, Service
from go_pocket_tts_tpu_torch.tts.voices import Voice, VoiceManager

__all__ = ["Service", "PCMChunk", "Voice", "VoiceManager"]
