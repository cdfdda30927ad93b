from .entry_point import main

main()
