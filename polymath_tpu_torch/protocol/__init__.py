"""Protocol layer: setup / prove / verify and data structures."""
from .api import Polymath, Rng, PolymathError
from .data_structures import Proof, VerifyingKey, ProvingKey, PairingVK
