"""One module a traffic kind (a traffic file's ``kind``): ``setup``,
``window``, ``finish`` and ``check``, as ``core.py`` describes."""
