from stepth.cli import main

raise SystemExit(main())
