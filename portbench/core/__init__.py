"""The harness: environment, manifest, statistics, device traces and the
result line, shared by every driver."""
