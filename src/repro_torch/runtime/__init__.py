"""Runtime step builders (the counterpart of the reference package's
``runtime``); this slice ports the serve steps for one device."""
