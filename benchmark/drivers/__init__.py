"""One driver a traffic kind; `benchmark/traffic/<mix>.json` names its kind."""
