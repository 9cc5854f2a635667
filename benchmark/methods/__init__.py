"""The methods the benchmark runs, one module each, found by the `method`
key of a configuration's file (manifest.Manifest.method)."""
