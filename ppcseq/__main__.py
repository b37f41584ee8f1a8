from ppcseq.cli import main

raise SystemExit(main())
