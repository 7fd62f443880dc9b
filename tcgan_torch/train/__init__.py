"""Run plumbing: datastore (run directory and ``info.json``)."""
