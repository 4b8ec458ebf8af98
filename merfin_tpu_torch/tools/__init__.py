"""Stand-alone tools of the torch port: ``genomescope.py`` (the -prob
lookup-table generator) and ``scatter_polish.py`` (the variant modes
sharded by scaffold stripe, then gathered)."""
