"""Stand-alone tools of the torch port: ``genomescope.py`` (the -prob
lookup-table generator)."""
