"""Fiat-Shamir transcripts: Merlin (STROBE-128), Keccak256, Blake3."""
from .transcripts import (
    Transcript, MerlinFieldTranscript, Keccak256Transcript, Blake3Transcript,
    ALL_TRANSCRIPTS,
)
