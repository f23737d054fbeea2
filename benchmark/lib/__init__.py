"""The harness: spec lookups, rendering, entries, trace, yardstick, check."""
