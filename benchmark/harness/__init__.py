"""The harness: specs, key store, window, trace reduction and check."""
